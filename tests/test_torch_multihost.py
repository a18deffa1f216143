"""Multi-process runs of the port (the mpiexec analog, route (ii) of
parallel/sharded_engine.py) and the rank launcher's failure paths.

The two tests of tests/test_multihost.py: two OS processes started by
`python -m torch.distributed.run --standalone --nproc-per-node 2` join one
gloo group through `parallel.multihost.initialize()` (read from the
launcher's environment) and run, in place on every rank, one sharded rhs
(ShardedEngine) or a whole 3-step `Problem(..., ndev=2)` transient; rank 0
writes the gathered fields, which must match the JAX package's
single-process engine at tests/test_multihost.py's tolerances. The end time
of the transient is held to test_torch_cli.py's STEP_T_TOL (absolute), the
port's tolerance for step times against the JAX package: from the third
step on dt follows the error norm's last bits, and the port's own
single-device run ends 1.3e-8 (relative) from the JAX package's here, so
the JAX test's 1e-12, a property of two JAX runs, does not carry over;
for the same reason the transient's fields are held to the port's
transient tolerance against the JAX package (test_torch_cli.py's RTOL,
ATOL: 1e-6, 1e-8), where the JAX test holds two JAX runs to 1e-8, 1e-9.
The worker is the script WORKER below (it imports only the port).

The launcher (parallel/comm.py run_ranks): a rank that raises makes the
caller raise at once with that rank's traceback; a rank that hangs makes
its peers' next collective raise at the collective timeout, and the caller
raises with that traceback and the silent rank's number; CUDA asked for on
a machine without a card raises before any rank starts; no rank process
outlives a call.
"""
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pynama_tpu.cases import Problem as JProblem
from pynama_tpu.engine import rhs_local as jrhs_local
from pynama_tpu_torch.parallel.comm import backend_for, run_ranks

import torch_rank_jobs as jobs
from multihost_worker import cavity_config, random_state
from test_torch_cli import ATOL, RTOL, STEP_T_TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = '''
import sys
import numpy as np
import torch
from pynama_tpu_torch.cases import Problem
from pynama_tpu_torch.parallel.multihost import initialize, is_primary
from pynama_tpu_torch.parallel.sharded_engine import ShardedEngine, job_rhs

torch.set_num_threads(1)
mode, out, cfg = sys.argv[1], sys.argv[2], eval(sys.argv[3])
info = initialize(device="cpu")
assert info["process_count"] == 2 and info["global_devices"] == 2, info
assert info["local_devices"] == 1, info
kw = dict(device=info["device"], dtype=torch.float64, solver="cg",
          cg_rtol=1e-12, cg_maxiter=3000)
if mode == "transient":
    p = Problem(cfg, ndev=2, **kw)
    p.setUp()
    t, steps = p.start_solver(dt0=1e-3, atol=1e-6, rtol=1e-6, tableau="5bs")
    if is_primary():
        np.savez(out, t=t, steps=steps, w=p.vort.numpy(), v=p.vel.numpy(),
                 iters=np.array(p.rank_stats[0]["cg_iters"]))
else:
    p = Problem(cfg, **kw)
    p.setUp()
    rng = np.random.default_rng(11)
    vort = rng.standard_normal((p.mesh.n_nodes, p.dim_w))
    vel = rng.standard_normal((p.mesh.n_nodes, p.dim))
    se = ShardedEngine(p, 2)
    res = job_rhs(se, 0.0, vort, vel)
    if is_primary():
        np.savez(out, f=res["fields"]["f"], v=res["fields"]["vel"],
                 backend=se.backend)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
'''


def run_workers(tmp_path, mode, cfg):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = str(tmp_path / "out.npz")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script), mode, out, repr(cfg)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return np.load(out)


def test_two_process_rhs_matches_single(tmp_path):
    got = run_workers(tmp_path, "rhs", cavity_config())
    assert str(got["backend"]) == "gloo"
    p1 = JProblem(cavity_config(), solver="cg", cg_rtol=1e-12,
                  cg_maxiter=3000)
    p1.setUp()
    vort_g, vel_g = random_state(p1)
    f_l, v_l = jrhs_local(p1.engine_ops, 0.0, p1.to_local(vort_g),
                          p1.to_local(vel_g))
    np.testing.assert_allclose(got["f"], p1.to_global(np.asarray(f_l),
                                                      p1.dim_w),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got["v"], p1.to_global(np.asarray(v_l),
                                                      p1.dim),
                               rtol=1e-10, atol=1e-11)


def test_two_process_transient_matches_single(tmp_path):
    """A whole 3-step adaptive transient with Problem(..., ndev=2) run in
    place on both processes: every accepted step runs the two-stage KLE CG
    with cross-process psums, and the dt controller stays in lockstep."""
    cfg = cavity_config()
    cfg["time-solver"]["max-steps"] = 3
    got = run_workers(tmp_path, "transient", cfg)
    assert int(got["steps"]) == 3
    p1 = JProblem(cfg, solver="cg", cg_rtol=1e-12, cg_maxiter=3000)
    p1.setUp()
    t1, steps1 = p1.start_solver(dt0=1e-3, atol=1e-6, rtol=1e-6,
                                 tableau="5bs")
    assert steps1 == 3
    assert abs(float(got["t"]) - t1) <= STEP_T_TOL
    np.testing.assert_allclose(got["w"], np.asarray(p1.vort), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["v"], np.asarray(p1.vel), rtol=RTOL,
                               atol=ATOL)


def test_rank_failure_raises_with_traceback():
    """A rank that raises: the caller raises at once with its traceback,
    and no rank is left; a rank that hangs is killed once its peer's
    collective times out."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_ranks(jobs.fail_on_rank_1, [()] * 3, device="cpu", timeout=120)
    assert time.monotonic() - t0 < 60
    msg = str(err.value)
    assert "rank 1 of 3 raised" in msg
    assert "ValueError: rank 1 fails on purpose" in msg
    assert "fail_on_rank_1" in msg
    assert multiprocessing.active_children() == []
    t0 = time.monotonic()
    # rank 0 waits for rank 1 at the closing barrier until the collective
    # timeout; rank 1 never reports
    with pytest.raises(RuntimeError) as err:
        run_ranks(jobs.hang_on_rank_1, [()] * 2, device="cpu", timeout=20)
    assert time.monotonic() - t0 < 40
    msg = str(err.value)
    assert "rank 0 of 2 raised" in msg
    assert "Timed out" in msg
    assert "ranks [1] of 2 gave no result" in msg
    assert multiprocessing.active_children() == []


def test_cuda_without_card_raises_before_ranks():
    """ndev=2 on cuda with no card raises at once; no rank starts on the
    CPU instead. The backend rule on the CPU is gloo, unstaged."""
    assert backend_for("cpu", 4) == ("gloo", False)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="is_available"):
        run_ranks(jobs.hang_on_rank_1, [()] * 2, device="cuda", timeout=20)
    assert time.monotonic() - t0 < 2
    assert multiprocessing.active_children() == []
