"""Port parity of tests/test_ibm_sharded.py: the sharded IBM correction
(ibm/sharded.py) and `ImmersedBoundary*._start_solver_sharded_ibm`, plus
the file's three single-device checks (the SpGEMM core, the matrix-free
correction against the Cholesky one, the moving body's device-side
steps).

At the JAX tests' tolerances: the rank-local correction 1e-10 relative /
1e-12 absolute against the global one, sharded runs 1e-8 and their force
histories 1e-6 against the JAX package's `ndev` runs. 2 and 4 ranks where
the JAX tests take 4 and 8 devices.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.cases.ibm import ImmersedBoundaryDynamic as JDyn
from pynama_tpu.cases.ibm import ImmersedBoundaryStatic as JStat
from pynama_tpu.ibm import interpolation as JI
from pynama_tpu.ibm.sharded import build_ibm_shard_tables as jtables
from pynama_tpu.mesh import BoxMesh as JBoxMesh
from pynama_tpu_torch.cases.ibm import ImmersedBoundaryDynamic as TDyn
from pynama_tpu_torch.cases.ibm import ImmersedBoundaryStatic as TStat
from pynama_tpu_torch.ibm import interpolation as TI
from pynama_tpu_torch.ibm.bodies import Circle
from pynama_tpu_torch.ibm.sharded import build_ibm_shard_tables
from pynama_tpu_torch.mesh import BoxMesh as TBoxMesh
from pynama_tpu_torch.ops import local as TL
from pynama_tpu_torch.parallel.comm import run_ranks

import torch_rank_jobs as jobs
from test_ibm import ibm_config
from test_torch_sharded_engine import F64, assert_lockstep

torch.set_num_threads(1)


def circle(nelem=16):
    """(JAX ops, nodes, w), (port ops, nodes, w), port mesh, body: the
    cylinder of tests/test_ibm_sharded.py through both packages."""
    jm = JBoxMesh.create(3, (nelem, nelem), [-3, -3], [3, 3])
    tm = TBoxMesh.create(3, (nelem, nelem), [-3, -3], [3, 3])
    body = Circle(radius=0.5)
    body.create(tm.node_separation())
    xy = body.coordinates()
    jops = JI.make_ibm_ops(jm, body.dl, dtype=np.float64)
    tops = TI.make_ibm_ops(tm, body.dl, **F64)
    jn, jw = JI.support_tables(jops, xy)
    tn, tw = TI.support_tables(tops, torch.as_tensor(xy))
    return (jops, jn, jw), (tops, tn, tw), tm, body


def test_normal_core_spgemm_matches_dense():
    """C = W Wᵀ through sparse/spgemm.py == the dense eq-tensor core, and
    both == the JAX package's dense core."""
    (jops, jn, jw), (tops, tn, tw), _, _ = circle()
    C_sp = TI.normal_core_spgemm(tops, tn, tw)
    C_dense = TI.normal_core(tops, tn, tw).numpy()
    np.testing.assert_allclose(C_sp, C_dense, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(C_sp, np.asarray(JI.normal_core(jops, jn, jw)),
                               rtol=1e-12, atol=1e-14)


def test_correction_cg_matches_cholesky():
    """The matrix-free CG correction reproduces the Cholesky one, and the
    JAX package's CG correction."""
    (jops, jn, jw), (tops, tn, tw), tm, body = circle()
    chol = torch.linalg.cholesky(TI.normal_core(tops, tn, tw))
    rng = np.random.default_rng(3)
    vel = rng.standard_normal((tm.n_nodes, 2))
    bv = rng.standard_normal((body.n_nodes, 2))
    t = lambda a: torch.as_tensor(a)
    corr_ref, flux_ref = TI.correction(tops, tn, tw, chol, t(vel), t(bv),
                                       n_nodes=tm.n_nodes)
    corr_cg, flux_cg, stats = TI.correction_cg(
        tops, tn, tw, t(vel), t(bv), torch.zeros_like(t(bv)),
        n_nodes=tm.n_nodes, rtol=1e-13)
    assert float(stats[1]) < 1e-10
    np.testing.assert_allclose(flux_cg.numpy(), flux_ref.numpy(), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(corr_cg.numpy(), corr_ref.numpy(), rtol=1e-8,
                               atol=1e-10)
    _, jflux, _ = JI.correction_cg(jops, jn, jw, jnp.asarray(vel),
                                   jnp.asarray(bv), jnp.zeros_like(bv),
                                   n_nodes=tm.n_nodes, rtol=1e-13)
    np.testing.assert_allclose(flux_cg.numpy(), np.asarray(jflux),
                               rtol=1e-8, atol=1e-10)


def test_dynamic_runs_device_side():
    """The moving body steps with its per-step correction on the device:
    3 steps (direct KLE solve), finite fields, the warm-started flux kept,
    one (iterations, residual) record per correction, and the JAX
    package's fields."""
    cfg = ibm_config(nelem=16, vel="dynamic", max_steps=3)
    p = TDyn(cfg, **F64, solver="direct")
    p.setUp()
    t, steps = p.start_solver(dt0=1e-3)
    assert steps == 3
    assert np.isfinite(p.vel.numpy()).all()
    assert np.isfinite(p._flux.numpy()).all()
    assert len(p.corr_log) == steps + 1
    pj = JDyn(cfg, solver="direct")
    pj.setUp()
    tj, sj = pj.start_solver(dt0=1e-3)
    assert sj == steps and abs(tj - t) <= 1e-12
    np.testing.assert_allclose(p.vel.numpy(), np.asarray(pj.vel),
                               rtol=1e-8, atol=1e-8)


def test_correction_local_matches_global():
    """The rank-local gather/solve/spread on 4 ranks == the single-device
    correction; the port's per-rank tables == the JAX package's."""
    ndev = 4
    (jops, jn, jw), (tops, tn, tw), tm, body = circle()
    slots, gw, sw = build_ibm_shard_tables(tm, tn.numpy(), tw.numpy(), ndev)
    js, jg, jsw = jtables(JBoxMesh.create(3, (16, 16), [-3, -3], [3, 3]),
                          jn, jw, ndev)
    np.testing.assert_array_equal(slots, np.asarray(js))
    np.testing.assert_array_equal(gw, np.asarray(jg))
    np.testing.assert_array_equal(sw, np.asarray(jsw))
    chol = torch.linalg.cholesky(TI.normal_core(tops, tn, tw))
    rng = np.random.default_rng(5)
    vel_g = rng.standard_normal((tm.n_nodes, 2))
    bv = rng.standard_normal((body.n_nodes, 2))
    jchol = jnp.linalg.cholesky(JI.normal_core(jops, jn, jw))
    corr_ref, flux_ref = JI.correction(jops, jn, jw, jchol,
                                       jnp.asarray(vel_g), jnp.asarray(bv),
                                       n_nodes=tm.n_nodes)
    vel_l = TL.to_local(tm, vel_g).reshape(ndev, -1, 18)
    scale = float(tops.dl) * float(tops.h)
    out = run_ranks(jobs.correction_ranks, [
        (slots[d], gw[d], sw[d], chol.numpy(), scale, vel_l[d], bv)
        for d in range(ndev)], device="cpu")
    for _, flux in out:
        np.testing.assert_allclose(flux, np.asarray(flux_ref), rtol=1e-10,
                                   atol=1e-12)
    # every rank's flux is the same bits (the psum is)
    assert all(np.array_equal(out[0][1], f) for _, f in out)
    want = TL.to_local(tm, vel_g + np.asarray(corr_ref))
    got = np.concatenate([o for o, _ in out]).reshape(-1, 18)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def run_pair(cls_j, cls_t, cfg, ndev):
    opts = dict(solver="cg", cg_rtol=1e-12, cg_maxiter=4000, ndev=ndev)
    pj = cls_j(cfg, **opts)
    pj.setUp()
    pj.start_solver(dt0=1e-3)
    pt = cls_t(cfg, **F64, **opts)
    pt.setUp()
    pt.start_solver(dt0=1e-3)
    assert len(pt.rank_stats) == ndev
    assert_lockstep([{"stats": s} for s in pt.rank_stats])
    np.testing.assert_allclose(pt.vel.numpy(), np.asarray(pj.vel),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(pt.vort.numpy(), np.asarray(pj.vort),
                               rtol=1e-8, atol=1e-8)
    for key in ("cd", "cl", "cd_phys", "cl_phys"):
        np.testing.assert_allclose(np.asarray(pt.history[key]),
                                   np.asarray(pj.history[key]), rtol=1e-6,
                                   atol=1e-8, err_msg=key)
    assert pt.history["steps"] == pj.history["steps"]
    return pj, pt


@pytest.mark.parametrize("ndev", [2])
def test_sharded_static_matches_single(ndev):
    """ibm-static under -ndev: the JAX package's -ndev trajectory and
    force history."""
    run_pair(JStat, TStat, ibm_config(nelem=16, max_steps=3), ndev)


@pytest.mark.parametrize("ndev", [4])
def test_sharded_dynamic_matches_single(ndev):
    """ibm-dynamic under -ndev: the moving body's tables rebuilt per rank
    and step, the matrix-free correction with a psum per C application;
    the JAX package's -ndev trajectory and force history, and a
    correction record per accept."""
    _, pt = run_pair(JDyn, TDyn, ibm_config(nelem=16, vel="dynamic",
                                            max_steps=3), ndev)
    assert len(pt.corr_log) == 4
    assert np.isfinite(pt._flux.numpy()).all()
