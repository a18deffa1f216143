"""Port parity: whole sharded transients through `Problem(..., ndev=N)`.

The transient cases of tests/test_sharded_engine.py: the port spawns N
gloo ranks from `start_solver` (parallel/sharded_engine.py, route (i)) and
its fields are held against the JAX package's `ndev=N` run on the virtual
CPU devices at the JAX tests' tolerances: the same accepted steps, fields
to 1e-6 relative / 1e-9 absolute (FDM 1e-5 / 1e-8: its psum reorders the
mode-grid summation and the dt controller compounds it). 4 ranks where the
JAX tests take 8. Every rank must have taken the same steps and CG
iterations.

The FDM transient runs on 2 ranks: on the CPU each CG iteration waits on
three collectives, and 4 ranks would double its share of the file's time.
"""
import numpy as np
import torch

from pynama_tpu.cases import Problem as JProblem
from pynama_tpu_torch.cases import Problem as TProblem

from test_sharded_engine import cavity_config
from test_torch_sharded_engine import F64, assert_lockstep

torch.set_num_threads(1)


def run_pair(cfg, ndev, run, **opts):
    """(JAX, port) Problems of cfg with ndev devices/ranks, each set up and
    run through start_solver(**run); returns them with (t, steps)."""
    pj = JProblem(cfg, ndev=ndev, **opts)
    pj.setUp()
    tj, sj = pj.start_solver(**run)
    pt = TProblem(cfg, **F64, ndev=ndev, **opts)
    pt.setUp()
    tt, st = pt.start_solver(**run)
    assert len(pt.rank_stats) == ndev
    assert_lockstep([{"stats": s} for s in pt.rank_stats])
    return pj, pt, (tj, sj), (tt, st)


def test_sharded_transient_matches_single_device():
    """The whole -ndev production transient (host dt controller + sharded
    attempt + accepted-state BC pin) against the JAX package's."""
    cfg = cavity_config(8, 3, 2)
    cfg["time-solver"] = {"start-time": 0, "end-time": 1.0, "max-steps": 5}
    pj, pt, (tj, sj), (tt, st) = run_pair(
        cfg, 4, dict(dt0=1e-3, atol=1e-6, rtol=1e-6), solver="cg",
        cg_rtol=1e-13, cg_maxiter=4000)
    assert st == sj >= 3
    assert [s for s, _, _ in pt.rank_stats[0]["accepted"]] == \
        list(range(1, st + 1))
    assert abs(tt - tj) <= 1e-6 * max(1.0, abs(tj))
    np.testing.assert_allclose(pt.vort.numpy(), np.asarray(pj.vort),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(pt.vel.numpy(), np.asarray(pj.vel),
                               rtol=1e-6, atol=1e-9)


def test_sharded_fdm_transient():
    """The -ndev transient under pc="fdm" (the slab FDM on both stages)."""
    cfg = cavity_config(8, 3, 2)
    cfg["time-solver"] = {"start-time": 0, "end-time": 1.0, "max-steps": 4}
    pj, pt, (tj, sj), (tt, st) = run_pair(
        cfg, 2, dict(dt0=1e-3, atol=1e-6, rtol=1e-6), solver="cg",
        pc="fdm", cg_rtol=1e-13, cg_maxiter=4000)
    assert pt.engine_ops.pc == "fdm"
    assert st == sj >= 3
    np.testing.assert_allclose(pt.vort.numpy(), np.asarray(pj.vort),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(pt.vel.numpy(), np.asarray(pj.vel),
                               rtol=1e-5, atol=1e-8)
