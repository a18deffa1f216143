"""Port parity: the overlapped sharded DSS (ops/local.py dss_overlapped,
`overlap_dss=True`) and the counterpart of test_graft_entry.

The overlapped DSS is a scheduling variant of the plain sharded box DSS:
the plane exchange is posted before the axes-1..d-1 passes and waited for
after them. Its fields equal the plain DSS's up to the order of the
summation (tests/test_sharded_engine.py's tolerances: rhs 1e-9 / 1e-11,
transient 1e-7 / 1e-10), and the JAX package's overlapped run to the
sharded rhs and transient tolerances (1e-8 / 1e-9, 1e-6 / 1e-9). The
overlapped DSS is the plain route's, so these runs take `fused=False`
(the JAX package's default on the CPU); with the fused kernel the planes
travel as K1's `bnd` instead.
"""
import numpy as np
import pytest
import torch

from pynama_tpu.cases import Problem as JProblem
from pynama_tpu.parallel.sharded_engine import ShardedEngine as JShardedEngine
from pynama_tpu_torch.cases import Problem as TProblem
from pynama_tpu_torch.engine import local_engine as TE
from pynama_tpu_torch.parallel.sharded_engine import (job_rhs_overlap_pair,
                                                       run_sharded)

from test_sharded_engine import cavity_config
from test_torch_sharded_engine import F64, assert_lockstep
from test_torch_sharded_transient import run_pair

torch.set_num_threads(1)


@pytest.mark.parametrize("dim", [2, 3])
def test_overlapped_dss_matches(dim):
    """2D on 4 ranks, 3D on 2 (two slabs of 4 element layers)."""
    cfg = cavity_config(8, 3, dim)
    opts = dict(solver="cg", cg_rtol=1e-12, cg_maxiter=3000)
    pj = JProblem(cfg, **opts)
    pj.setUp()
    pt = TProblem(cfg, **F64, fused=False, **opts)
    pt.setUp()
    rng = np.random.default_rng(7)
    vort = rng.standard_normal((pt.mesh.n_nodes, pt.dim_w))
    vel = np.zeros((pt.mesh.n_nodes, pt.dim))
    ndev = 4 if dim == 2 else 2
    sk = JShardedEngine(pj, ndev, overlap_dss=True)
    vort_s, vel_s = sk.shard_state(vort, vel)
    f_s, _ = sk.make_rhs()(sk.ops_s, 0.1, vort_s, vel_s)
    want = sk.gather_state(f_s, pj.dim_w)
    res = run_sharded(pt, ndev, job_rhs_overlap_pair, (0.1, vort, vel))
    got = res[0]["fields"]
    for k in ("f", "vel"):
        np.testing.assert_allclose(got["overlapped"][k], got["plain"][k],
                                   rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got["overlapped"]["f"], want, rtol=1e-8,
                               atol=1e-9)
    assert_lockstep(res)


def test_overlapped_dss_transient():
    """The -ndev transient with overlap_dss on: the same steps as the plain
    sharded run and the JAX package's overlapped run, fields within the
    tolerances above. 2 ranks (see test_torch_sharded_transient.py)."""
    cfg = cavity_config(8, 3, 2)
    cfg["time-solver"] = {"start-time": 0, "end-time": 0.01, "max-steps": 3}
    run = dict(dt0=1e-3, atol=1e-4, rtol=1e-4)
    opts = dict(solver="cg", cg_rtol=1e-12, cg_maxiter=3000)
    pj, pt, (tj, sj), (tt, st) = run_pair(cfg, 2, run, overlap_dss=True,
                                          fused=False, **opts)
    plain = TProblem(cfg, **F64, ndev=2, fused=False, **opts)
    plain.setUp()
    tp, sp = plain.start_solver(**run)
    assert st == sp == sj
    np.testing.assert_allclose(pt.vort.numpy(), plain.vort.numpy(),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(pt.vort.numpy(), np.asarray(pj.vort),
                               rtol=1e-6, atol=1e-9)


def test_sharded_dryrun_transient():
    """__graft_entry__'s two parts on the port: its forward step (rhs_local
    on the 16^2 ngl=5 Taylor-Green case) is finite and equals the JAX
    package's; its dryrun_multichip transient on 2 ranks (its mesh rule,
    a (2N, 2) no-slip cavity at ngl=3, pc="fdm", CG rtol 1e-10 capped at
    200 iterations) takes >= 3 steps, reports each accepted step to
    post_step in order, and ends on the JAX package's 2-device fields."""
    import __graft_entry__ as ge
    fn, args = ge.entry()
    want = np.asarray(fn(*args)[0])
    p = TProblem(ge._tg_config((16, 16), 5), **F64, solver="cg",
                 cg_rtol=1e-12, cg_maxiter=300)
    p.setUp()
    got, _ = TE.rhs_local(p.engine_ops, 0.0, p.to_local(p.vort),
                          p.to_local(p.vel))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8,
                               atol=1e-9 * np.abs(want).max())

    cfg = ge._cavity_config((4, 2), 3)
    cfg["time-solver"] = {"start-time": 0.0, "end-time": 1.0,
                          "max-steps": 4}
    seen = []
    pj, pt, (tj, sj), (tt, st) = run_pair(
        cfg, 2, dict(dt0=1e-3, atol=1e-3, rtol=1e-3,
                     post_step=lambda step, t, dt, y, aux: seen.append(
                         (step, np.asarray(y).shape))),
        solver="cg", cg_rtol=1e-10, cg_maxiter=200, pc="fdm")
    assert st == sj >= 3
    # JAX's post_step saw its own steps first, then the port's
    port_seen = seen[sj:]
    assert [s for s, _ in port_seen] == list(range(1, st + 1))
    assert all(shape == (pt.mesh.n_nodes, pt.dim_w) for _, shape in
               port_seen)
    assert np.isfinite(pt.vort.numpy()).all()
    np.testing.assert_allclose(pt.vort.numpy(), np.asarray(pj.vort),
                               rtol=1e-6, atol=1e-9)
