"""The port's slice as a whole: pynama_tpu_torch Problem against pynama_tpu
Problem on the no-slip cavity transient and the Taylor-Green decay (setUp
-> build_engine -> _start_solver_local -> adaptive_solve -> rhs_local),
float64 on the CPU; and the port's time stepper on the cases of
tests/test_timestep.py.

Both run solver="cg" at cg_rtol=1e-13 with the adaptive Bogacki-Shampine
5(4) stepper at atol=rtol=1e-8 to t=0.01. They must accept the same number
of steps, end at the same time (1e-12) and agree on vort/vel to rtol 1e-6,
atol 1e-8 — the tolerance of tests/test_engine.py::test_transient_matches,
for the same reason: the CG solves converge to 1e-13, not to round-off, and
the step controller integrates those differences.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.cases import Problem as JProblem
from pynama_tpu.solver import timestep as JT
from pynama_tpu_torch.cases import Problem as TProblem
from pynama_tpu_torch.solver import timestep as TT

from test_engine import cavity_config
from test_transient import tg_config

torch.set_num_threads(1)

OPTS = dict(solver="cg", cg_rtol=1e-13, cg_maxiter=4000)


@pytest.mark.parametrize("dim,nelem", [(3, 2), (2, 4)])
def test_cavity_transient_matches(dim, nelem):
    cfg = cavity_config(ngl=3, nelem=nelem, dim=dim)
    pj = JProblem(cfg, **OPTS)
    pj.setUp()
    pt = TProblem(cfg, device="cpu", dtype=torch.float64, **OPTS)
    pt.setUp()
    assert list(pt.setup_phases) == list(pj.setup_phases)
    pt.cg_log = []
    tj, sj = pj.start_solver(atol=1e-8, rtol=1e-8, dt0=1e-3)
    tt, st = pt.start_solver(atol=1e-8, rtol=1e-8, dt0=1e-3)
    assert st == sj and st > 0
    assert abs(tt - tj) < 1e-12
    np.testing.assert_allclose(pt.vort.numpy(), np.asarray(pj.vort),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(pt.vel.numpy(), np.asarray(pj.vel),
                               rtol=1e-6, atol=1e-8)
    assert np.abs(pt.vort.numpy()).max() > 0
    # two solves (FS stage + main) per right-hand side, 8 stages per attempt
    assert len(pt.cg_log) > 0 and len(pt.cg_log) % 16 == 0


def test_problem_rejects_unported_paths():
    cfg = cavity_config(ngl=3, nelem=2, dim=2)
    with pytest.raises(NotImplementedError, match="item 10"):
        TProblem(cfg, device="cpu", solver="direct").setUp()
    p = TProblem(cfg, device="cpu", dtype=torch.float64, ndev=2)
    p.setUp()
    with pytest.raises(NotImplementedError, match="item 14"):
        p.start_solver()


def test_taylor_green_decay_matches():
    """The 2D Taylor-Green vortex (tests/test_transient.py's case at 4^2
    ngl=5 to t=0.05, CG instead of the direct solve): the same accepted
    steps and end time as the JAX package, fields to rtol 1e-6, and the
    analytic vorticity within 1.01x the JAX package's own error."""
    cfg = tg_config(ngl=5, nelem=4, tend=0.05)
    run = dict(atol=1e-7, rtol=1e-7, dt0=1e-3)
    pj = JProblem(cfg, **OPTS)
    pj.setUp()
    pt = TProblem(cfg, device="cpu", dtype=torch.float64, **OPTS)
    pt.setUp()
    np.testing.assert_array_equal(pt.vort.numpy(), np.asarray(pj.vort))
    np.testing.assert_array_equal(pt.vel.numpy(), np.asarray(pj.vel))
    tj, sj = pj.start_solver(**run)
    tt, st = pt.start_solver(**run)
    assert st == sj and st > 0
    assert abs(tt - tj) < 1e-12 and abs(tt - 0.05) < 1e-12
    np.testing.assert_allclose(pt.vort.numpy(), np.asarray(pj.vort),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(pt.vel.numpy(), np.asarray(pj.vel),
                               rtol=1e-6, atol=1e-8)
    w_exact = pt.exact_fields(tt)[1].numpy()
    np.testing.assert_allclose(w_exact, np.asarray(pj.exact_fields(tj)[1]),
                               rtol=1e-13, atol=0)
    scale = np.abs(w_exact).max()
    err_t = np.abs(pt.vort.numpy() - w_exact).max() / scale
    err_j = np.abs(np.asarray(pj.vort) - w_exact).max() / scale
    assert 0 < err_t <= 1.01 * err_j, (err_t, err_j)


@pytest.mark.parametrize("name", ["5bs", "5dp"])
def test_tableau_order_conditions(name):
    """tests/test_timestep.py::test_order_conditions on the port's
    tableaus, which equal the JAX package's."""
    tab, ref = TT.get_tableau(name), JT.get_tableau(name)
    for key in ("a", "b", "b_emb", "c"):
        np.testing.assert_array_equal(getattr(tab, key), getattr(ref, key))
    assert (tab.order, tab.order_emb) == (ref.order, ref.order_emb)
    a, c = tab.a, tab.c
    for bv, order in ((tab.b, tab.order), (tab.b_emb, tab.order_emb)):
        conds = [(bv.sum(), 1.0), (bv @ c, 1 / 2), (bv @ c**2, 1 / 3),
                 (bv @ (a @ c), 1 / 6), (bv @ c**3, 1 / 4),
                 ((bv * c) @ (a @ c), 1 / 8), (bv @ (a @ c**2), 1 / 12),
                 (bv @ (a @ (a @ c)), 1 / 24)]
        if order >= 5:
            conds += [(bv @ c**4, 1 / 5), ((bv * c**2) @ (a @ c), 1 / 10),
                      (bv @ ((a @ c) ** 2), 1 / 20),
                      ((bv * c) @ (a @ c**2), 1 / 15),
                      (bv @ (a @ c**3), 1 / 20),
                      ((bv * c) @ (a @ (a @ c)), 1 / 30),
                      (bv @ ((a * c[None, :]) @ (a @ c)), 1 / 40),
                      (bv @ (a @ (a @ c**2)), 1 / 60),
                      (bv @ (a @ (a @ (a @ c))), 1 / 120)]
        for got, want in conds:
            np.testing.assert_allclose(got, want, atol=1e-13)


@pytest.mark.parametrize("name", ["5bs", "5dp"])
def test_scalar_ode_matches(name):
    """y' = -y to t=1: exp(-1) within the controller's tolerance, with the
    JAX stepper's accepted steps and end value."""
    def rhs_t(t, y, aux):
        return -y, aux

    def rhs_j(t, y, aux):
        return -y, aux

    kw = dict(dt0=0.1, atol=1e-8, rtol=1e-8, tableau=name)
    t, y, _, steps = TT.adaptive_solve(
        rhs_t, 0.0, 1.0, torch.tensor([1.0], dtype=torch.float64), None,
        **kw)
    tj, yj, _, sj = JT.adaptive_solve(rhs_j, 0.0, 1.0, jnp.array([1.0]),
                                      None, jit=False, **kw)
    np.testing.assert_allclose(t, 1.0, atol=1e-12)
    np.testing.assert_allclose(float(y[0]), np.exp(-1.0), rtol=1e-7)
    assert steps == sj > 0
    np.testing.assert_allclose(float(y[0]), float(yj[0]), rtol=1e-14)


def test_matchstep_endpoint():
    """MATCHSTEP: the final time is hit exactly, never overshot."""
    times = []

    def rhs(t, y, aux):
        return 0.0 * y, aux

    def post(step, t, dt, y, aux):
        times.append(t)

    t, _, _, _ = TT.adaptive_solve(rhs, 0.0, 0.37,
                                   torch.tensor([1.0], dtype=torch.float64),
                                   None, dt0=0.1, post_step=post)
    np.testing.assert_allclose(t, 0.37, atol=1e-14)
    assert max(times) <= 0.37 + 1e-14


def test_step_convergence_order():
    """The fixed-step error of the 5th-order update scales like dt^5."""
    tab = TT.get_tableau("5bs")

    def rhs(t, y, aux):
        return y * np.cos(t), aux

    attempt = TT.make_step(rhs, tab, atol=1.0, rtol=0.0)
    errs = []
    for n in (8, 16):
        dt = 1.0 / n
        y = torch.tensor([1.0], dtype=torch.float64)
        t = 0.0
        for _ in range(n):
            y = attempt(t, dt, y, None).y
            t += dt
        errs.append(abs(float(y[0]) - np.exp(np.sin(1.0))))
    rate = np.log2(errs[0] / errs[1])
    assert rate > 4.5, f"observed order {rate}"
