"""Port parity: pc="schwarz" of pynama_tpu_torch against pynama_tpu's
(float64 on the CPU).

The Schwarz preconditioner is the JAX package's weighted additive
overlapping Schwarz by element mixed with Jacobi:
M_inv(r) = free·DSS((free·r·inv_mult) @ KinvT)·inv_mult
+ 0.5·free·r/dmask + con·r, with KinvT the element pseudo-inverse built on the host. The port
builds KinvT with the reference's numpy code (bitwise equal here), applies
the DSS(t @ KinvT) through `_apply_mat` (K1 on a box mesh with fused=True,
its plain version on the CPU; the plain ops/local.py route with
fused=False or on a gather-DSS mesh), and must give the reference's M_inv
to 1e-12, its two-stage solves under CG and GMRES to 1e-10 (CG counts
within 3%, as tests/test_torch_engine.py allows at rtol 1e-13), its CLI
run, and its sharded rhs. Where the reference has no shared element K to
invert (per-element matrices on gmsh meshes), both fall back to Jacobi.
"""
import contextlib
import dataclasses
import importlib
import logging

import numpy as np
import pytest
import torch

from pynama_tpu.cases import Problem as JProblem
from pynama_tpu.engine import local_engine as JE
from pynama_tpu.parallel.sharded_engine import ShardedEngine as JShardedEngine
from pynama_tpu_torch.cases import Problem as TProblem
from pynama_tpu_torch.engine import local_engine as TE
from pynama_tpu_torch.parallel.sharded_engine import job_rhs, run_sharded

from test_fdm import cavity
from test_sharded_engine import cavity_config as sharded_cavity
from test_torch_cli import assert_checkpoints_match, run_both
from test_torch_unstructured import TG, gmsh_config, write_mesh

torch.set_num_threads(1)

j_gmres_mod = importlib.import_module("pynama_tpu.solver.gmres")
F64 = torch.float64
SIZES = {2: (4, 3), 3: (3, 3)}           # dim -> (nelem per axis, ngl)
OPTS = dict(solver="cg", pc="schwarz", cg_rtol=1e-13, cg_maxiter=4000)
_CACHE = {}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-300)


def _pair(dim):
    """(JAX Problem, port Problem) of the no-slip cavity under Schwarz."""
    if dim not in _CACHE:
        cfg = cavity(*SIZES[dim], dim)
        pj = JProblem(cfg, **OPTS)
        pj.setUp()
        pt = TProblem(cfg, device="cpu", dtype=F64, **OPTS)
        pt.setUp()
        _CACHE[dim] = (pj, pt)
    return _CACHE[dim]


class _Grabbed(Exception):
    pass


def jax_minv(ops, free, monkeypatch):
    """The M_inv closure the JAX package's _masked_solve hands to pcg."""
    got = {}

    def grab(A, b, x0, M_inv=None, **kw):
        got["M_inv"] = M_inv
        raise _Grabbed

    monkeypatch.setattr(JE, "pcg", grab)
    z = np.zeros(np.asarray(ops.free_main).shape)
    vort = np.zeros(np.asarray(ops.winv_w).shape)
    with pytest.raises(_Grabbed):
        JE._masked_solve(ops, free, vort, z)
    monkeypatch.undo()
    return got["M_inv"]


def _residual(p, seed, free):
    """A consistent element-local vector, zero on the constrained dofs (as
    every CG residual is), from a numpy-seeded global one."""
    rng = np.random.default_rng(seed)
    r = np.asarray(p.to_local(rng.standard_normal((p.mesh.n_nodes, p.dim))))
    return r * np.asarray(free)


@contextlib.contextmanager
def _recording_jax_solvers(iters):
    """The JAX package's pcg and gmres, appending each solve's iteration
    count to `iters`."""
    pcg, gmres = JE.pcg, j_gmres_mod.gmres

    def wrap(fn):
        def rec(*args, **kwargs):
            res = fn(*args, **kwargs)
            iters.append(int(res.iters))
            return res
        return rec

    JE.pcg, j_gmres_mod.gmres = wrap(pcg), wrap(gmres)
    try:
        yield
    finally:
        JE.pcg, j_gmres_mod.gmres = pcg, gmres


# ----------------------------------------------------------------- setup
@pytest.mark.parametrize("dim", [2, 3])
def test_kinvt_matches(dim):
    """KinvT is the reference's (host eigh in f64, cut at 1e-10·λmax), in
    the engine's dtype; it goes through ops_to_numpy / ops_from_numpy with
    the other arrays, and ops_from_numpy refuses pc="schwarz" without it."""
    pj, pt = _pair(dim)
    assert pj.engine_ops.pc == pt.engine_ops.pc == "schwarz"
    kj = np.asarray(pj.engine_ops.KinvT)
    kt = pt.engine_ops.KinvT
    assert kt.dtype == F64 and tuple(kt.shape) == kj.shape
    assert _rel(kt.numpy(), kj) <= 1e-12
    np.testing.assert_array_equal(TE.element_pinv_T(pt._em.K), kt.numpy())
    # a pseudo-inverse: K K+ K = K, K+ K K+ = K+
    K, Kp = np.asarray(pt._em.K), kt.numpy().T
    assert _rel(K @ Kp @ K, K) <= 1e-9 and _rel(Kp @ K @ Kp, Kp) <= 1e-9
    arrays = TE.ops_to_numpy(pt.engine_ops)
    pjac = TProblem(cavity(*SIZES[dim], dim), device="cpu", dtype=F64,
                    solver="cg")
    pjac.setUp()
    assert pjac.engine_ops.KinvT is None
    assert "KinvT" in arrays and "KinvT" not in TE.ops_to_numpy(
        pjac.engine_ops)
    ops = pt.engine_ops
    kw = dict(ngl=ops.ngl, nelem=ops.nelem, dim=ops.dim, dim_w=ops.dim_w,
              dim_s=ops.dim_s, is_ns=ops.is_ns, cg_rtol=ops.cg_rtol,
              cg_atol=ops.cg_atol, cg_maxiter=ops.cg_maxiter, device="cpu")
    back = TE.ops_from_numpy(arrays, dtype=torch.float32, pc="schwarz", **kw)
    assert back.KinvT.dtype == torch.float32
    assert torch.equal(back.KinvT, ops.KinvT.float())
    del arrays["KinvT"]
    with pytest.raises(ValueError, match="KinvT"):
        TE.ops_from_numpy(arrays, dtype=F64, pc="schwarz", **kw)


# ---------------------------------------------------------- preconditioner
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_minv_matches(dim, fused, monkeypatch):
    """One M_inv(r) of each masked system against the reference's, with
    the port's DSS(t @ KinvT) through fused_apply (fused=True) or the plain
    ops/local.py route (fused=False)."""
    pj, pt = _pair(dim)
    ops = dataclasses.replace(pt.engine_ops, fused=fused)
    for seed, stage in enumerate(("free_fs", "free_main")):
        free_j = getattr(pj.engine_ops, stage)
        r = _residual(pt, seed, free_j)
        r[1] += 0.5          # an off-contract input too: con·r passes
        want = np.asarray(jax_minv(pj.engine_ops, free_j, monkeypatch)(r))
        got = TE.preconditioner(ops, getattr(ops, stage))(torch.as_tensor(r))
        assert _rel(got.numpy(), want) <= 1e-12, stage


@pytest.mark.parametrize("dim", [2, 3])
def test_minv_contract_and_symmetry(dim):
    """The constrained-dof contract (z_con == 0 exactly when r_con == 0),
    and M_inv symmetric and positive on the free subspace in the engine's
    ownership-weighted dot, as CG needs."""
    _, pt = _pair(dim)
    ops = pt.engine_ops
    dot = TE._dot_v(ops)
    for stage in ("free_fs", "free_main"):
        free = getattr(ops, stage)
        M = TE.preconditioner(ops, free)
        a = torch.as_tensor(_residual(pt, 1, free))
        b = torch.as_tensor(_residual(pt, 2, free))
        za, zb = M(a), M(b)
        assert torch.equal(za[free == 0], torch.zeros_like(za[free == 0]))
        ab, ba = float(dot(za, b)), float(dot(a, zb))
        assert abs(ab - ba) <= 1e-12 * abs(ab)
        assert float(dot(za, a)) > 0 and float(dot(zb, b)) > 0


def test_gather_dss_route_matches(tmp_path, monkeypatch):
    """On a gather-DSS (gmsh) mesh with one shared element K handed to
    build_engine directly, Schwarz takes the plain ops/local.py route, and
    M_inv is the reference's."""
    path = write_mesh(tmp_path / "g.msh", "quad", (3, 3), 0.0)
    cfg = gmsh_config(path, 3, {"no-slip": {
        "up": [1, 0], "down": [0, 0], "left": [0, 0], "right": [0, 0]}})
    pt = TProblem(cfg, device="cpu", dtype=F64, solver="cg")
    pt.setUp()
    pj = JProblem(cfg, solver="cg")
    pj.setUp()
    # every cell's own matrices are one matrix on this undistorted grid up
    # to orientation; the first cell's, shared, is what both packages get
    pick = lambda a: np.asarray(a)[0] if np.ndim(a) == 3 else np.asarray(a)
    em, eo = pt._em, pt._eo
    mats = [pick(m) for m in (em.K, em.Rw, eo.Curl, eo.SrT, eo.DivSrT)]
    args = (pt.mesh, pt.bc, *mats, eo.weight, 1.0, 0.01)
    tops = TE.build_engine(*args, device="cpu", dtype=F64, pc="schwarz")
    jops = JE.build_engine(pj.mesh, pj.bc, *mats, eo.weight, 1.0, 0.01,
                           dtype=np.float64, pc="schwarz")
    assert not tops.lay_v.structured and tops.pc == jops.pc == "schwarz"
    assert _rel(tops.KinvT.numpy(), np.asarray(jops.KinvT)) <= 1e-12
    free = np.asarray(jops.free_main)
    r = _residual(pt, 3, free)
    want = np.asarray(jax_minv(jops, jops.free_main, monkeypatch)(r))
    got = TE.preconditioner(tops, tops.free_main)(torch.as_tensor(r))
    assert _rel(got.numpy(), want) <= 1e-12


def test_per_element_k_falls_back(tmp_path, caplog):
    """A gmsh mesh has one K per element and no shared one to invert: both
    packages build pc="jacobi" with no KinvT, and the port says why; on a
    box mesh sumfact=True keeps Schwarz (its KinvT is the shared dense
    element K's, as the reference builds it)."""
    path = write_mesh(tmp_path / "u.msh", "quad", (3, 3), 0.1)
    cfg = gmsh_config(path, 3, TG, TG, TG)
    with caplog.at_level(logging.WARNING, "pynama_tpu_torch.engine"):
        pt = TProblem(cfg, device="cpu", dtype=F64, solver="cg",
                      pc="schwarz", sumfact=False)
        pt.setUp()
    pj = JProblem(cfg, solver="cg", pc="schwarz", sumfact=False)
    pj.setUp()
    assert np.ndim(pt._em.K) == 3
    assert pt.engine_ops.pc == pj.engine_ops.pc == "jacobi"
    assert pt.engine_ops.KinvT is None and pj.engine_ops.KinvT is None
    assert "using pc='jacobi'" in caplog.text
    box = cavity(*SIZES[3], 3)
    pt = TProblem(box, device="cpu", dtype=F64, sumfact=True, **OPTS)
    pt.setUp()
    pj = JProblem(box, sumfact=True, **OPTS)
    pj.setUp()
    assert pt.engine_ops.sumfact is not None
    assert pt.engine_ops.pc == pj.engine_ops.pc == "schwarz"
    assert _rel(pt.engine_ops.KinvT.numpy(), np.asarray(pj.engine_ops.KinvT)) \
        <= 1e-12


# ------------------------------------------------------------------ solves
def _solve_both(pj, ops, seed):
    rng = np.random.default_rng(seed)
    vort = rng.standard_normal((pj.mesh.n_nodes, pj.dim_w))
    vort_l = np.array(pj.to_local(vort))
    vel_l = np.array(pj.to_local(pj.vel))
    jits, stats = [], []
    with _recording_jax_solvers(jits):
        _, vj = JE.solve_kle_local(pj.engine_ops, vort_l, vel_l, 0.0)
    _, vt = TE.solve_kle_local(ops, torch.as_tensor(vort_l),
                               torch.as_tensor(vel_l), 0.0, stats)
    return np.asarray(vj), vt.numpy(), jits, [int(it) for it, _ in stats]


@pytest.mark.parametrize("fused", [True, False])
def test_cg_solve_matches(fused):
    """The 3D no-slip cavity's two-stage solve under Schwarz-PCG at rtol
    1e-13: the reference's velocity to 1e-10, its counts within 3%, and
    more iterations than Jacobi's on the free-slip stage (the reference's
    finding)."""
    pj, pt = _pair(3)
    ops = dataclasses.replace(pt.engine_ops, fused=fused)
    vj, vt, jits, tits = _solve_both(pj, ops, 4)
    assert _rel(vt, vj) <= 1e-10
    assert len(tits) == len(jits) == 2
    assert all(abs(a - b) <= max(1, 0.03 * b) for a, b in zip(tits, jits)), \
        (tits, jits)
    jac = dataclasses.replace(ops, pc="jacobi")
    stats = []
    TE.solve_kle_local(jac, pt.to_local(np.random.default_rng(4)
                                        .standard_normal((pt.mesh.n_nodes,
                                                          3))),
                       pt.to_local(pt.vel), 0.0, stats)
    assert tits[0] > int(stats[0][0])


@pytest.mark.parametrize("ne,ngl,dim", [(2, 2, 3), (2, 3, 2)])
def test_gmres_solve_matches(ne, ngl, dim):
    """The same under restarted GMRES(30) at rtol 1e-12, on cavities small
    enough that the restart cycles do not amplify summation-order
    differences (on a 2^3 ngl=3 cavity the free-slip stage's 2,206 Arnoldi
    steps became 2,939): the reference's Arnoldi steps, its velocity to
    1e-10."""
    cfg = cavity(ne, ngl, dim)
    opts = dict(OPTS, solver="gmres", cg_rtol=1e-12)
    pj = JProblem(cfg, **opts)
    pj.setUp()
    pt = TProblem(cfg, device="cpu", dtype=F64, **opts)
    pt.setUp()
    assert pt.engine_ops.krylov == "gmres" and pt.engine_ops.pc == "schwarz"
    vj, vt, jits, tits = _solve_both(pj, pt.engine_ops, 5)
    assert tits == jits and len(jits) == 2
    assert max(jits) < opts["cg_maxiter"]
    assert _rel(vt, vj) <= 1e-10


# --------------------------------------------------------- CLI and sharded
def test_cli_pc_schwarz(tmp_path, monkeypatch):
    """-pc schwarz through both CLIs (taylor-green 3x3 ngl=3, CG): the
    engine takes Schwarz and the checkpoints match."""
    args = ["-case", "taylor-green", "-log", "WARNING", "-nelem", "3", "3",
            "-ngl", "3", "-solver", "cg", "-cg-rtol", "1e-10", "-pc",
            "schwarz", "-checkpoint", "ck.h5"]
    dj, dt, (p, t, steps) = run_both(tmp_path, monkeypatch, args)
    assert p.engine_ops.pc == "schwarz" and p.engine_ops.KinvT is not None
    assert steps >= 3
    assert_checkpoints_match(dj / "ck.h5", dt / "ck.h5")


@pytest.mark.parametrize("dim,fused,overlap", [(2, True, False),
                                               (3, True, False),
                                               (2, False, True)])
def test_sharded_rhs_matches(dim, fused, overlap):
    """Two ranks under Schwarz against the JAX package's two-device
    ShardedEngine (its KinvT broadcast, its _dss exchanging under
    shard_map): one rhs, 1e-8 relative / 1e-10 absolute (the sharded FDM
    test's tolerance), every rank in lockstep. The port's Schwarz
    applications take K1 and the plane exchange (fused), or the plain
    route's overlapped DSS."""
    cfg = sharded_cavity(4, 3, dim)
    opts = dict(OPTS, cg_rtol=1e-12, cg_maxiter=3000)
    pj = JProblem(cfg, **opts)
    pj.setUp()
    pt = TProblem(cfg, device="cpu", dtype=F64, fused=fused, **opts)
    pt.setUp()
    rng = np.random.default_rng(12)
    vort = rng.standard_normal((pt.mesh.n_nodes, pt.dim_w))
    vel = np.zeros((pt.mesh.n_nodes, pt.dim))
    sk = JShardedEngine(pj, 2)
    assert sk.ops_s.pc == "schwarz"
    vort_s, vel_s = sk.shard_state(vort, vel)
    f_s, _ = sk.make_rhs()(sk.ops_s, 0.1, vort_s, vel_s)
    want = sk.gather_state(f_s, pj.dim_w)
    res = run_sharded(pt, 2, job_rhs, (0.1, vort, vel), overlap_dss=overlap)
    assert len(res) == 2 and res[0]["stats"]["backend"] == "gloo"
    np.testing.assert_allclose(res[0]["fields"]["f"], want, rtol=1e-8,
                               atol=1e-10)
    assert res[1]["stats"]["cg_iters"] == res[0]["stats"]["cg_iters"]
