"""The global-layout path of the port's Problem against the JAX package's:
solver="auto" / "direct" / "cg" with engine=False / "gmres", Problem.rhs,
Operators, kle_errors, operators_errors and diagnostics, float64 on the
CPU.

Each test runs the reference's own case (tests/test_solver.py,
test_operators.py, test_diagnostics.py, test_gmres.py) through both
packages: the port must meet the reference's tolerances and agree with the
JAX package's numbers. The direct solves agree to round-off; the iterative
ones to their tolerance.
"""
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import pynama_tpu.cases.problem as JPM
from pynama_tpu.bc import BoundaryConditions as JBC
from pynama_tpu.cases import Problem as JProblem
from pynama_tpu.cases.problem import compute_vtensv as j_vtensv
from pynama_tpu.config import get_config as j_get_config
from pynama_tpu.engine import local_engine as JE
from pynama_tpu.mesh import BoxMesh as JBox
from pynama_tpu_torch.cases import Problem as TProblem
from pynama_tpu_torch.cases.problem import compute_vtensv
from pynama_tpu_torch.config import get_config
from pynama_tpu_torch.engine import local_engine as TE
from pynama_tpu_torch.mesh import BoxMesh as TBox

from test_3d import tg3_config
from test_engine import cavity_config
from test_operators import senoidal_config, tg3d_config
from test_solver import tg_config, uniform_config
from test_torch_fdm import _recording_jax_gmres

torch.set_num_threads(1)

F64 = torch.float64
YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pynama_tpu", "cases", "yaml")
CASE_FILES = sorted(f[:-5] for f in os.listdir(YAML) if f.endswith(".yaml"))


def _pair(cfg, **opts):
    pj = JProblem(cfg, **opts)
    pj.setUp()
    pt = TProblem(cfg, device="cpu", dtype=F64, **opts)
    pt.setUp()
    assert pt.solver_method == pj.solver_method
    assert (pt.engine_ops is None) == (pj.engine_ops is None)
    return pj, pt


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


# ------------------------------------------------------------ solver="auto"

def test_default_solver_is_auto():
    cfg, jcfg = get_config(), j_get_config()
    assert cfg.solver == jcfg.solver == "auto"
    assert cfg.direct_max_dofs == jcfg.direct_max_dofs == 40_000


def _jax_resolution(cfg, monkeypatch):
    """The JAX package's solver_method for a case file, from its own
    _build_kle_solver with the system build stubbed out (no assembly, no
    factorization)."""
    monkeypatch.setattr(JPM, "build_system", lambda **kw: kw["method"])
    monkeypatch.setattr(JPM, "make_element_op", lambda *a, **k: None)
    monkeypatch.setattr(JPM, "KLESolver", lambda **kw: None)
    p = JProblem(cfg)
    box = cfg["domain"]["box-mesh"]
    p.mesh = JBox.create(cfg["domain"]["ngl"], box["nelem"], box["lower"],
                         box["upper"])
    p.dim, p.dim_w = p.mesh.dim, p.mesh.dim_w
    p.bc = JBC(p.mesh, dict(cfg["boundary-conditions"]))
    p._em = types.SimpleNamespace(K=np.zeros(1), Rw=None)
    p.dtype = np.float64
    p._build_kle_solver()
    return p.solver_method


@pytest.mark.parametrize("name", CASE_FILES)
def test_auto_resolution_matches_case_files(name, monkeypatch):
    """Every case file of the reference (all on box meshes) resolves
    "auto" to the JAX package's solver: direct at or below 40,000 velocity
    dofs, cg above."""
    with open(os.path.join(YAML, name + ".yaml")) as fh:
        cfg = yaml.safe_load(fh)
    box = cfg["domain"]["box-mesh"]
    pt = TProblem(cfg, device="cpu")
    pt.mesh = TBox.create(cfg["domain"]["ngl"], box["nelem"], box["lower"],
                          box["upper"])
    pt.dim = pt.mesh.dim
    got = pt._resolve_solver()
    want = _jax_resolution(cfg, monkeypatch)
    assert got == want
    dofs = pt.mesh.n_nodes * pt.dim
    assert got == ("direct" if dofs <= 40_000 else "cg")


def test_auto_builds_direct_and_rejects_unknown():
    cfg = uniform_config(nelem=(3, 3))
    pt = TProblem(cfg, device="cpu", dtype=F64)
    pt.setUp()
    assert pt.solver_method == "direct" and pt.engine_ops is None
    assert pt.kle.main.chol is not None and not pt.kle.is_ns
    with pytest.raises(ValueError, match="unknown solver"):
        TProblem(cfg, device="cpu", solver="lu").setUp()


# ------------------------------------------------------- tests/test_solver

@pytest.mark.parametrize("solver,opts,tol", [
    ("direct", {}, 1e-12), ("cg", {"engine": False}, 1e-12),
    ("gmres", {}, 1e-10), ("gmres", {"engine": False}, 1e-10)])
def test_uniform_flow(solver, opts, tol):
    """Uniform flow reproduced to 1e-12 (test_solver.py; 1e-10 for GMRES,
    test_gmres.py), the JAX package's velocity to 1e-12."""
    pj, pt = _pair(uniform_config(), solver=solver, **opts)
    vort = np.zeros((pt.mesh.n_nodes, 1))
    _, vel = pt.solve_kle(vort, pt.vel, 0.0)
    _, vj = pj.solve_kle(jnp.asarray(vort), pj.vel, 0.0)
    exact = np.tile([4.0, 0.0], (pt.mesh.n_nodes, 1))
    assert np.linalg.norm(vel.numpy() - exact) < tol
    assert np.abs(vel.numpy() - np.asarray(vj)).max() < 1e-12


@pytest.mark.parametrize("solver,opts", [("direct", {}),
                                         ("cg", {"engine": False})])
def test_taylor_green_t0(solver, opts):
    """TG at t=0, 10x10 ngl=5: error < 1e-5 (test_solver.py), equal to the
    JAX package's error to 1e-6 relative."""
    pj, pt = _pair(tg_config(), solver=solver, **opts)
    ev, ew = pt.exact_fields(0.0)
    _, vel = pt.solve_kle(ew, pt.vel, 0.0)
    err = float(np.linalg.norm(vel.numpy() - ev.numpy()))
    evj, ewj = pj.exact_fields(0.0)
    _, vj = pj.solve_kle(ewj, pj.vel, 0.0)
    err_j = float(np.linalg.norm(np.asarray(vj) - np.asarray(evj)))
    assert err < 1e-5
    assert err == pytest.approx(err_j, rel=1e-6)


@pytest.mark.parametrize("solver,opts,atol", [
    ("cg", {}, 1e-8), ("cg", {"engine": False}, 1e-8), ("gmres", {}, 1e-7),
    ("gmres", {"engine": False}, 1e-7)])
def test_iterative_matches_direct(solver, opts, atol):
    """test_cg_matches_direct (1e-8) and test_kle_solver_gmres_matches_direct
    (1e-7), engine and global layouts."""
    cfg = tg_config(nelem=(4, 4), ngl=4)
    pd = TProblem(cfg, device="cpu", dtype=F64, solver="direct")
    pd.setUp()
    pi = TProblem(cfg, device="cpu", dtype=F64, solver=solver, **opts)
    pi.setUp()
    pi.cg_log = []
    _, ew = pd.exact_fields(0.1)
    _, v1 = pd.solve_kle(ew, pd.vel, 0.1)
    _, v2 = pi.solve_kle(ew, pi.vel, 0.1)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), atol=atol)
    assert len(pi.cg_log) == 1 and int(pi.cg_log[0][0]) > 0


def test_engine_gmres_iterations_match_jax():
    """The engine's krylov="gmres" under Jacobi (the default
    preconditioner): the JAX package's Arnoldi step count on both stages
    of a no-slip cavity solve, the same velocity."""
    cfg = cavity_config(ngl=3, nelem=3, dim=2)
    pj, pt = _pair(cfg, solver="gmres", cg_rtol=1e-12)
    assert pt.engine_ops.krylov == "gmres" and pt.engine_ops.pc == "jacobi"
    rng = np.random.default_rng(5)
    vort = rng.standard_normal((pt.mesh.n_nodes, pt.dim_w))
    vel = rng.standard_normal((pt.mesh.n_nodes, pt.dim))
    jits, stats = [], []
    with _recording_jax_gmres(jits):
        _, vj = JE.solve_kle_local(pj.engine_ops, pj.to_local(vort),
                                   pj.to_local(vel), 0.0)
    _, vt = TE.solve_kle_local(pt.engine_ops, pt.to_local(vort),
                               pt.to_local(vel), 0.0, stats)
    assert [it for it, _ in stats] == jits and len(jits) == 2
    assert all(n >= it + 2 for it, n in stats)
    assert _rel(vt.numpy(), vj) <= 1e-9


def test_kle_errors_sweep():
    """getKLEError-style sweep (direct, ngl=7): small errors, equal to the
    JAX package's."""
    pj, pt = _pair(tg_config(nelem=(4, 4), ngl=7), solver="direct")
    errs = pt.kle_errors([0.2, 0.5, 0.9])
    assert all(e < 1e-4 for e in errs)
    np.testing.assert_allclose(errs, pj.kle_errors([0.2, 0.5, 0.9]),
                               rtol=1e-8)


def test_compute_vtensv():
    vel = torch.tensor([[1.0, 2.0], [3.0, -1.0]], dtype=F64)
    np.testing.assert_allclose(compute_vtensv(vel, 2).numpy(),
                               [[1, 2, 4], [9, -3, 1]])
    vel3 = torch.tensor([[1.0, 2.0, 3.0]], dtype=F64)
    np.testing.assert_allclose(compute_vtensv(vel3, 3).numpy(),
                               [[1, 2, 4, 6, 9, 3]])
    rng = np.random.default_rng(0)
    for dim in (2, 3):
        v = rng.standard_normal((7, dim))
        np.testing.assert_array_equal(
            compute_vtensv(torch.as_tensor(v), dim).numpy(),
            np.asarray(j_vtensv(jnp.asarray(v), dim)))


def test_p_convergence():
    """The KLE error falls monotonically with ngl (direct), and equals the
    JAX package's at each ngl."""
    errs, errs_j = [], []
    for ngl in (3, 5, 7):
        pj, pt = _pair(tg_config(nelem=(4, 4), ngl=ngl), solver="direct")
        errs.append(pt.kle_errors([0.5])[0])
        errs_j.append(pj.kle_errors([0.5])[0])
    assert errs[0] > errs[1] > errs[2]
    assert errs[2] < 1e-5
    np.testing.assert_allclose(errs, errs_j, rtol=1e-8)


# ---------------------------------------------------- tests/test_operators

def test_operators_p_convergence_2d():
    errs = []
    for ngl in (3, 5, 7):
        pj, pt = _pair(senoidal_config(ngl=ngl), solver="direct")
        e = pt.operators_errors(viscous_time=1.0)
        np.testing.assert_allclose(e, pj.operators_errors(1.0), rtol=1e-8)
        errs.append(e)
    conv, diff, curl = zip(*errs)
    assert conv[0] > conv[-1] and diff[0] > diff[-1] and curl[0] > curl[-1]
    assert curl[-1] < 1e-3


def test_operators_3d():
    e = {}
    for ngl in (4, 6):
        pj, pt = _pair(tg3d_config(nelem=(2, 2, 2), ngl=ngl), solver="cg",
                       engine=False)
        e[ngl] = pt.operators_errors(viscous_time=1.0)
        np.testing.assert_allclose(e[ngl], pj.operators_errors(1.0),
                                   rtol=1e-8)
    assert all(b < a for a, b in zip(e[4], e[6]))


def test_operators_match_engine():
    """Operators.curl/srt/div_srt (global apply_op) against the engine's
    curl/srt/div_srt (fused_apply's plain version) on the analytic
    velocity: the same operators in two layouts, to 1e-12."""
    pt = TProblem(tg3d_config(nelem=(2, 3, 2), ngl=3), device="cpu",
                  dtype=F64, solver="cg")
    pt.setUp()
    ops, op = pt.engine_ops, pt.operator
    v = pt.exact_fields(0.3)[0]
    for glob, eng, c in ((op.curl, TE.curl, pt.dim_w),
                         (op.srt, TE.srt, pt.dim_s)):
        want = pt.to_global(eng(ops, pt.to_local(v)), c)
        assert _rel(glob(v).numpy(), want) <= 1e-12
    s = op.srt(v)
    want = pt.to_global(TE.div_srt(ops, pt.to_local(s)), pt.dim)
    assert _rel(op.div_srt(s).numpy(), want) <= 1e-12
    w = pt.operator.weight.numpy()
    assert w.shape == (pt.mesh.n_nodes, 1) and w.sum() == pytest.approx(1.0)
    np.testing.assert_allclose(pt.operator.winv.numpy() * w, 1.0,
                               rtol=1e-15)


# --------------------------------------------------- tests/test_diagnostics

def test_diagnostics_taylor_green():
    """KE = rho/4 and enstrophy = 2 pi^2 on [0,1]^2; every monitor equal to
    the JAX package's."""
    pj, pt = _pair(tg_config(nelem=(6, 6), ngl=5), solver="direct")
    ev, ew = pt.exact_fields(0.0)
    _, vel = pt.solve_kle(ew, pt.vel, 0.0)
    d = pt.diagnostics(vel=vel, vort=ew)
    assert d["kinetic_energy"] == pytest.approx(0.25, rel=1e-5)
    assert d["enstrophy"] == pytest.approx(2 * np.pi**2, rel=1e-6)
    assert d["div_l2"] < 5e-3
    evj, ewj = pj.exact_fields(0.0)
    _, vj = pj.solve_kle(ewj, pj.vel, 0.0)
    dj = pj.diagnostics(vel=vj, vort=ewj)
    for k in d:
        assert d[k] == pytest.approx(dj[k], rel=1e-8), k
    # numpy fields in, the current state by default
    assert pt.diagnostics(vel=vel.numpy(), vort=ew.numpy()) == d
    assert pt.diagnostics()["kinetic_energy"] == pytest.approx(
        pj.diagnostics()["kinetic_energy"], rel=1e-12)


def test_diagnostics_3d():
    pj, pt = _pair(tg3_config(4), solver="direct")
    _, ew = pt.exact_fields(0.0)
    _, vel = pt.solve_kle(ew, pt.vel, 0.0)
    d = pt.diagnostics(vel=vel, vort=ew)
    assert d["kinetic_energy"] > 0 and d["enstrophy"] > 0
    assert np.isfinite(d["div_l2"])
    _, ewj = pj.exact_fields(0.0)
    _, vj = pj.solve_kle(ewj, pj.vel, 0.0)
    dj = pj.diagnostics(vel=vj, vort=ewj)
    for k in d:
        assert d[k] == pytest.approx(dj[k], rel=1e-8), k


# ------------------------------------------------- the global transient

@pytest.mark.parametrize("solver,opts", [("direct", {}),
                                         ("cg", {"engine": False})])
def test_global_transient_matches(solver, opts):
    """A 3-step no-slip cavity transient through Problem.rhs in the global
    layout (adaptive_solve on global fields, two-stage solves): the JAX
    package's steps, end time and fields to 1e-8. The stepper runs at
    1e-4, where every step's size factor is clipped (dt 1e-3, 1e-2, 1e-1):
    at 1e-8 the factor follows the error norm's last bits (tests/
    test_torch_transient.py, chip_smoke.parity_cases)."""
    cfg = cavity_config(ngl=3, nelem=4, dim=2)
    cfg["time-solver"].update({"max-steps": 3, "end-time": 1.0})
    pj, pt = _pair(cfg, solver=solver, cg_rtol=1e-13, cg_maxiter=4000,
                   **opts)
    assert pt.engine_ops is None and pt.kle.is_ns
    pt.cg_log = []
    run = dict(atol=1e-4, rtol=1e-4, dt0=1e-3)
    tj, sj = pj.start_solver(**run)
    tt, st = pt.start_solver(**run)
    assert st == sj == 3
    assert abs(tt - tj) < 1e-12 and abs(tt - 0.111) < 1e-12
    for got, want in ((pt.vort, pj.vort), (pt.vel, pj.vel)):
        assert got.device.type == "cpu" and got.dtype == F64
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-8, atol=1e-10)
    assert np.abs(pt.vort.numpy()).max() > 0
    # two solves per right-hand side, 8 right-hand sides per attempt
    assert len(pt.cg_log) == (0 if solver == "direct" else 48)


def test_rhs_direct_matches_engine():
    """One Problem.rhs of the direct solve against rhs_local of the engine
    (CG at rtol 1e-13) at the same random state, taken to the global
    layout: relative 1e-8 (chip_smoke's global_direct gate, small)."""
    cfg = cavity_config(ngl=3, nelem=4, dim=2)
    pd = TProblem(cfg, device="cpu", dtype=F64)
    pd.setUp()
    pc = TProblem(cfg, device="cpu", dtype=F64, solver="cg", cg_rtol=1e-13,
                  cg_maxiter=4000)
    pc.setUp()
    assert pd.solver_method == "direct"
    rng = np.random.default_rng(1)
    vort = rng.standard_normal((pd.mesh.n_nodes, pd.dim_w))
    vel = rng.standard_normal((pd.mesh.n_nodes, pd.dim))
    f_d, _ = pd.rhs(0.0, torch.as_tensor(vort), torch.as_tensor(vel))
    f_l, _ = TE.rhs_local(pc.engine_ops, 0.0, pc.to_local(vort),
                          pc.to_local(vel))
    assert _rel(f_d.numpy(), pc.to_global(f_l, pc.dim_w)) <= 1e-8
    f_j, _ = JProblem.rhs(_pair(cfg, solver="direct")[0], 0.0,
                          jnp.asarray(vort), jnp.asarray(vel))
    assert _rel(f_d.numpy(), f_j) <= 1e-12
