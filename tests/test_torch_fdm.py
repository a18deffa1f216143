"""Port parity: pynama_tpu_torch.solver.fdm and pc="fdm" against
pynama_tpu (float64 on the CPU).

The setup is the reference's numpy code carried over, so `build_fdm`'s
arrays agree to 1e-14 for both masked systems in 2D and 3D. The apply is
torch on both of its paths (strided slices, index gathers), against JAX's
at 1e-12. Then the reference's own claims, on the port's engine
(tests/test_fdm.py): the preconditioner is symmetric and definite, it cuts
cold-start CG iterations on both stages at 6^3 ngl=4 by the reference's
ratios, it reaches the Jacobi solution, and a Taylor-Green transient under
it takes Jacobi's steps and equals JAX's pc="fdm" run.
"""
import contextlib
import importlib
import logging

import numpy as np
import pytest
import torch

from pynama_tpu.cases import Problem as JProblem
from pynama_tpu.engine import local_engine as JE
from pynama_tpu.solver.fdm import fdm_apply as j_fdm_apply
from pynama_tpu_torch.cases import Problem as TProblem
from pynama_tpu_torch.engine import local_engine as TE
from pynama_tpu_torch.solver.cg import pcg
from pynama_tpu_torch.solver.fdm import fdm_apply

from test_fdm import cavity, tg

torch.set_num_threads(1)

# the module (pynama_tpu.solver re-exports a function of the same name)
j_gmres_mod = importlib.import_module("pynama_tpu.solver.gmres")
F64 = torch.float64
SIZES = {2: (4, 4), 3: (3, 3)}           # dim -> (nelem per axis, ngl)
_CACHE = {}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-300)


def _pair(dim):
    """(JAX Problem, port Problem) of the no-slip cavity under pc="fdm"."""
    if dim not in _CACHE:
        cfg = cavity(*SIZES[dim], dim)
        pj = JProblem(cfg, solver="cg", pc="fdm")
        pj.setUp()
        pt = TProblem(cfg, device="cpu", dtype=F64, solver="cg", pc="fdm")
        pt.setUp()
        _CACHE[dim] = (pj, pt)
    return _CACHE[dim]


@contextlib.contextmanager
def _recording_jax_gmres(iters):
    """The JAX package's gmres, appending each solve's iteration count to
    `iters` (its engine imports gmres from the module at call time)."""
    orig = j_gmres_mod.gmres

    def rec(*args, **kwargs):
        res = orig(*args, **kwargs)
        iters.append(int(res.iters))
        return res

    j_gmres_mod.gmres = rec
    try:
        yield
    finally:
        j_gmres_mod.gmres = orig


def _consistent(p, seed):
    """A consistent element-local velocity from a numpy-seeded global one."""
    rng = np.random.default_rng(seed)
    return np.array(p.to_local(rng.standard_normal((p.mesh.n_nodes,
                                                     p.dim))))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("system", ["fdm_main", "fdm_fs"])
def test_build_fdm_matches(dim, system):
    pj, pt = _pair(dim)
    assert pt.engine_ops.pc == pj.engine_ops.pc == "fdm"
    a, b = getattr(pt.engine_ops, system), getattr(pj.engine_ops, system)
    assert a.npts == b.npts and a.ncomp == b.ncomp == dim
    assert len(a.Qs) == len(b.Qs) == dim
    for qa, qb in zip(a.Qs, b.Qs):
        assert qa.shape == qb.shape and _rel(qa.numpy(), qb) <= 1e-14
    # binv inverts the per-mode blocks whose diagonal is the reference's
    # 1/dinv, so it carries the eigenvalue sums as well
    for key in ("binv", "jleft"):
        assert getattr(a, key).shape == getattr(b, key).shape, key
        assert _rel(getattr(a, key).numpy(), getattr(b, key)) <= 1e-14, key
    np.testing.assert_array_equal(a.rep_rows, np.asarray(b.rep_rows))
    np.testing.assert_array_equal(a.cell_nodes, np.asarray(b.cell_nodes))
    # the FS stage's corner rule leaves free dofs outside any tensor mask
    assert (float(np.abs(np.asarray(b.jleft)).max()) > 0) \
        == (system == "fdm_fs")


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("system", ["fdm_main", "fdm_fs"])
@pytest.mark.parametrize("path", ["strided", "gather"])
def test_fdm_apply_matches(dim, system, path):
    pj, pt = _pair(dim)
    r = _consistent(pj, 11)
    kw = dict(nelem=pt.engine_ops.nelem, ngl=pt.engine_ops.ngl) \
        if path == "strided" else {}
    got = fdm_apply(getattr(pt.engine_ops, system), torch.as_tensor(r), **kw)
    want = j_fdm_apply(getattr(pj.engine_ops, system), r, **kw)
    assert got.shape == r.shape
    assert _rel(got.numpy(), want) <= 1e-12
    if path == "gather":
        strided = fdm_apply(getattr(pt.engine_ops, system),
                            torch.as_tensor(r), nelem=pt.engine_ops.nelem,
                            ngl=pt.engine_ops.ngl)
        assert _rel(got.numpy(), strided.numpy()) <= 1e-14


@pytest.mark.parametrize("dim", [2, 3])
def test_fdm_spd_and_symmetric(dim):
    """Symmetric in the ownership-weighted inner product, and definite."""
    p = TProblem(cavity(4, 4, dim), device="cpu", dtype=F64, solver="cg",
                 pc="fdm")
    p.setUp()
    ops = p.engine_ops
    assert ops.pc == "fdm" and ops.fdm_main is not None
    dot = TE._dot_v(ops)
    for fdm in (ops.fdm_main, ops.fdm_fs):
        a = torch.as_tensor(_consistent(p, 1))
        b = torch.as_tensor(_consistent(p, 2))
        Ma, Mb = fdm_apply(fdm, a), fdm_apply(fdm, b)
        np.testing.assert_allclose(float(dot(b, Ma)), float(dot(a, Mb)),
                                   rtol=1e-10)
        assert float(dot(a, Ma)) > 0


def _cold_iters(p, free, fdm):
    """Cold-start masked CG iterations of one stage (the construction of
    tests/test_fdm.py::_solve_iters), and the true relative residual."""
    ops = p.engine_ops
    rng = np.random.default_rng(0)
    vort = p.to_local(rng.standard_normal((p.mesh.n_nodes, p.dim_w)))
    vort = TE.apply_vorticity_bc(ops, vort, 0.0)
    vel = TE.apply_velocity_bc(ops, p.to_local(p.vel), 0.0)
    con = 1.0 - free
    vc = con * vel
    b = free * (TE._apply_mat(ops, ops.lay_v, vort, ops.RwT)
                - TE.apply_K(ops, vc)) + vc
    A = lambda v: free * TE.apply_K(ops, free * v) + con * v
    if ops.pc == "fdm":
        M = lambda r: free * fdm_apply(fdm, free * r) + con * r
    else:
        dmask = free * ops.diag + con
        M = lambda r: r / dmask
    dot = TE._dot_v(ops)
    res = pcg(A, b, free * vel + vc, M_inv=M, rtol=1e-8, maxiter=5000,
              dot=dot)
    rr = b - A(res.x)
    return int(res.iters), float(torch.sqrt(dot(rr, rr) / dot(b, b)))


def test_fdm_iteration_win():
    """The reference's measurement at 6^3 ngl=4: FDM cuts cold-start CG
    iterations by >= 2.2x on the main stage and >= 1.35x on the FS stage."""
    iters = {}
    for pc in ("jacobi", "fdm"):
        p = TProblem(cavity(6, 4, 3), device="cpu", dtype=F64, solver="cg",
                     pc=pc)
        p.setUp()
        ops = p.engine_ops
        im, rm = _cold_iters(p, ops.free_main, ops.fdm_main)
        ifs, rfs = _cold_iters(p, ops.free_fs, ops.fdm_fs)
        assert rm < 1e-7 and rfs < 1e-7
        iters[pc] = (im, ifs)
    (jm, jf), (fm, ff) = iters["jacobi"], iters["fdm"]
    assert fm * 2.2 <= jm, f"main: fdm {fm} vs jacobi {jm}"
    assert ff * 1.35 <= jf, f"fs: fdm {ff} vs jacobi {jf}"


def test_fdm_solution_matches_jacobi():
    sols = {}
    for pc in ("jacobi", "fdm"):
        p = TProblem(cavity(6, 3, 2), device="cpu", dtype=F64, solver="cg",
                     cg_rtol=1e-12, cg_maxiter=4000, pc=pc)
        p.setUp()
        assert p.engine_ops.pc == pc
        sols[pc] = p.solve_kle(p.vort, p.vel, 0.0)[1].numpy()
    np.testing.assert_allclose(sols["fdm"], sols["jacobi"], rtol=1e-7,
                               atol=1e-9)


def test_fdm_taylor_green_transient():
    """The adaptive Taylor-Green transient under pc="fdm" takes the steps
    it takes under Jacobi, and equals JAX's pc="fdm" run."""
    cfg = tg(4, 4)
    cfg["time-solver"]["end-time"] = 0.03
    opts = dict(solver="cg", cg_rtol=1e-12, cg_maxiter=4000)
    run = dict(dt0=1e-3, atol=1e-6, rtol=1e-6)
    res = {}
    for pc in ("jacobi", "fdm"):
        p = TProblem(cfg, device="cpu", dtype=F64, pc=pc, **opts)
        p.setUp()
        res[pc] = p.start_solver(**run) + (p.vort.numpy(),)
    pj = JProblem(cfg, pc="fdm", **opts)
    pj.setUp()
    tj, sj = pj.start_solver(**run)
    assert res["fdm"][1] == res["jacobi"][1] == sj > 0
    assert abs(res["fdm"][0] - tj) < 1e-12
    np.testing.assert_allclose(res["fdm"][2], res["jacobi"][2], rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(res["fdm"][2], np.asarray(pj.vort),
                               rtol=1e-6, atol=1e-8)


def test_pc_fallback_and_left_out_options(caplog):
    """No tensor structure to diagonalize (nothing free along an axis):
    pc falls back to "jacobi", as in the reference, and says so. The
    Schwarz preconditioner builds as the reference's does, on the same
    mesh, with its element pseudo-inverse; an unknown name raises.
    krylov="gmres" builds, and its FDM-preconditioned solve takes the JAX
    package's iterations to the same velocity."""
    cfg = cavity(1, 2, 2)
    with caplog.at_level(logging.WARNING, "pynama_tpu_torch.engine"):
        p = TProblem(cfg, device="cpu", dtype=F64, solver="cg", pc="fdm")
        p.setUp()
    pj = JProblem(cfg, solver="cg", pc="fdm")
    pj.setUp()
    assert p.engine_ops.pc == pj.engine_ops.pc == "jacobi"
    assert p.engine_ops.fdm_main is None and p.engine_ops.fdm_fs is None
    assert "pc='jacobi'" in caplog.text
    ps = TProblem(cfg, device="cpu", dtype=F64, solver="cg", pc="schwarz")
    ps.setUp()
    pjs = JProblem(cfg, solver="cg", pc="schwarz")
    pjs.setUp()
    assert ps.engine_ops.pc == pjs.engine_ops.pc == "schwarz"
    np.testing.assert_allclose(ps.engine_ops.KinvT.numpy(),
                               np.asarray(pjs.engine_ops.KinvT), rtol=1e-12,
                               atol=1e-12 * float(np.abs(np.asarray(
                                   pjs.engine_ops.KinvT)).max()))
    with pytest.raises(ValueError, match="preconditioner"):
        TProblem(cfg, device="cpu", solver="cg", pc="ilu").setUp()
    pt = TProblem(cavity(2, 3, 2), device="cpu", dtype=F64, solver="cg")
    pt.setUp()
    ops = TE.build_engine(pt.mesh, pt.bc, pt._em.K, pt._em.Rw, pt._eo.Curl,
                          pt._eo.SrT, pt._eo.DivSrT, pt._eo.weight, 1.0,
                          0.01, device="cpu", dtype=F64, krylov="gmres",
                          pc="fdm", cg_rtol=1e-12)
    assert ops.krylov == "gmres" and ops.pc == "fdm"
    with pytest.raises(ValueError, match="Krylov"):
        TE.build_engine(pt.mesh, pt.bc, pt._em.K, pt._em.Rw, pt._eo.Curl,
                        pt._eo.SrT, pt._eo.DivSrT, pt._eo.weight, 1.0, 0.01,
                        device="cpu", dtype=F64, krylov="bicgstab")
    pj = JProblem(cavity(2, 3, 2), solver="gmres", pc="fdm", cg_rtol=1e-12)
    pj.setUp()
    rng = np.random.default_rng(4)
    vort = rng.standard_normal((pt.mesh.n_nodes, pt.dim_w))
    jits, stats = [], []
    with _recording_jax_gmres(jits):
        _, vj = JE.solve_kle_local(pj.engine_ops, pj.to_local(vort),
                                   pj.to_local(pj.vel), 0.0)
    _, vt = TE.solve_kle_local(ops, pt.to_local(vort), pt.to_local(pt.vel),
                               0.0, stats)
    assert [it for it, _ in stats] == jits and len(jits) == 2
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-8,
                               atol=1e-10)
