"""Port parity: the sharded engine of pynama_tpu_torch (one torch.distributed
rank per slab, gloo on the CPU) against the JAX package's ShardedEngine on
the virtual CPU devices of tests/conftest.py.

The cases of tests/test_sharded_engine.py that evaluate one rhs or one
trial step, at its tolerances: rhs 1e-8 relative / 1e-9 absolute (3D
1e-7 / 1e-8), the trial step 1e-8 / 1e-10 and its error norm 1e-8, the FDM
rhs 1e-8 / 1e-10. Rank counts are 1, 2 and 4 where the JAX tests use 1, 4
and 8; the JAX side runs at the port's count. One launch of ranks per test
computes everything the test compares, and every rank must have run the
same CG iterations (the lockstep of `parallel/comm.py`).
"""
import numpy as np
import pytest
import torch

from pynama_tpu.cases import Problem as JProblem
from pynama_tpu.parallel.sharded_engine import ShardedEngine as JShardedEngine
from pynama_tpu_torch.cases import Problem as TProblem
from pynama_tpu_torch.parallel.sharded_engine import job_rhs, run_sharded

import torch_rank_jobs as jobs

from test_sharded_engine import cavity_config, tg_config

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)


def problems(cfg, **opts):
    """(JAX Problem, port Problem) of cfg, both set up."""
    pj = JProblem(cfg, **opts)
    pj.setUp()
    pt = TProblem(cfg, **F64, **opts)
    pt.setUp()
    return pj, pt


def jax_rhs(pj, ndev, t, vort, vel):
    sk = JShardedEngine(pj, ndev)
    vort_s, vel_s = sk.shard_state(vort, vel)
    f_s, _ = sk.make_rhs()(sk.ops_s, t, vort_s, vel_s)
    return sk.gather_state(f_s, pj.dim_w), sk


def assert_lockstep(res):
    """Every rank ran the same steps and CG iterations."""
    first = res[0]["stats"]
    for r in res[1:]:
        assert r["stats"]["cg_iters"] == first["cg_iters"]
        assert r["stats"]["accepted"] == first["accepted"]
    assert [r["stats"]["rank"] for r in res] == list(range(len(res)))


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("cfg_fn", [cavity_config, tg_config])
def test_sharded_rhs_matches(ndev, cfg_fn):
    pj, pt = problems(cfg_fn(), solver="cg", cg_rtol=1e-13,
                      cg_maxiter=4000)
    rng = np.random.default_rng(0)
    vort = rng.standard_normal((pt.mesh.n_nodes, pt.dim_w))
    vel = np.zeros((pt.mesh.n_nodes, pt.dim))
    want, _ = jax_rhs(pj, ndev, 0.1, vort, vel)
    res = run_sharded(pt, ndev, job_rhs, (0.1, vort, vel))
    assert len(res) == ndev
    assert res[0]["stats"]["backend"] == ("single" if ndev == 1 else "gloo")
    np.testing.assert_allclose(res[0]["fields"]["f"], want, rtol=1e-8,
                               atol=1e-9)
    assert_lockstep(res)


def test_sharded_attempt_matches():
    """Full RK trial step: the port's 2-rank y and error norm match the
    JAX package's 2-device ones (16 solves at rtol 1e-13: on the CPU each
    CG iteration waits on three collectives)."""
    pj, pt = problems(cavity_config(8, 3, 2), solver="cg", cg_rtol=1e-13,
                      cg_maxiter=4000)
    rng = np.random.default_rng(2)
    vort = 0.1 * rng.standard_normal((pt.mesh.n_nodes, pt.dim_w))
    vel = np.zeros((pt.mesh.n_nodes, pt.dim))
    sk = JShardedEngine(pj, 2)
    vort_s, vel_s = sk.shard_state(vort, vel)
    y, enorm, _ = sk.make_attempt(atol=1e-6, rtol=1e-6)(
        sk.ops_s, 0.0, 1e-4, vort_s, vel_s)
    res = run_sharded(pt, 2, jobs.attempt,
                      (0.0, 1e-4, vort, vel, 1e-6, 1e-6))
    got = res[0]["fields"]
    np.testing.assert_allclose(got["y"], sk.gather_state(y, pj.dim_w),
                               rtol=1e-8, atol=1e-10)
    e = float(enorm)
    assert abs(got["enorm"] - e) < 1e-8 * max(1.0, abs(e))
    # 8 stages x two solves, the same on every rank
    assert len(res[0]["stats"]["cg_iters"]) == 16
    assert_lockstep(res)


def test_sharded_3d():
    pj, pt = problems(cavity_config(4, 3, 3), solver="cg", cg_rtol=1e-12,
                      cg_maxiter=3000)
    rng = np.random.default_rng(3)
    vort = rng.standard_normal((pt.mesh.n_nodes, 3))
    vel = np.zeros((pt.mesh.n_nodes, 3))
    want, _ = jax_rhs(pj, 2, 0.0, vort, vel)
    res = run_sharded(pt, 2, job_rhs, (0.0, vort, vel))
    np.testing.assert_allclose(res[0]["fields"]["f"], want, rtol=1e-7,
                               atol=1e-8)
    assert_lockstep(res)


@pytest.mark.parametrize("dim,ndev", [(2, 4), (3, 2)])
def test_sharded_fdm_rhs_matches(dim, ndev):
    """The slab FDM (solver/fdm.py shard_fdm, fdm_apply_slab) under
    pc="fdm": the ownership-weighted axis-0 projection and its psum, the
    free-slip stage's SlabFDM and the jleft slab slices."""
    pj, pt = problems(cavity_config(8, 3, dim), solver="cg", pc="fdm",
                      cg_rtol=1e-12, cg_maxiter=3000)
    assert pj.engine_ops.pc == pt.engine_ops.pc == "fdm"
    rng = np.random.default_rng(11)
    vort = rng.standard_normal((pt.mesh.n_nodes, pt.dim_w))
    vel = np.zeros((pt.mesh.n_nodes, pt.dim))
    want, sk = jax_rhs(pj, ndev, 0.1, vort, vel)
    assert sk.ops_s.pc == "fdm"
    res = run_sharded(pt, ndev, job_rhs, (0.1, vort, vel))
    np.testing.assert_allclose(res[0]["fields"]["f"], want, rtol=1e-8,
                               atol=1e-10)
    assert_lockstep(res)
