"""The port's slice as a whole: pynama_tpu_torch Problem against pynama_tpu
Problem on the no-slip cavity transient (setUp -> build_engine ->
_start_solver_local -> adaptive_solve -> rhs_local), float64 on the CPU.

Both run solver="cg" at cg_rtol=1e-13 with the adaptive Bogacki-Shampine
5(4) stepper at atol=rtol=1e-8 to t=0.01. They must accept the same number
of steps, end at the same time (1e-12) and agree on vort/vel to rtol 1e-6,
atol 1e-8 — the tolerance of tests/test_engine.py::test_transient_matches,
for the same reason: the CG solves converge to 1e-13, not to round-off, and
the step controller integrates those differences.
"""
import numpy as np
import pytest
import torch

from pynama_tpu.cases import Problem as JProblem
from pynama_tpu_torch.cases import Problem as TProblem

from test_engine import cavity_config

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
    cfg_ic = dict(cfg, **{"initial-conditions": {
        "custom-func": {"name": "taylor_green"}}})
    with pytest.raises(NotImplementedError, match="item 5"):
        TProblem(cfg_ic, device="cpu").setUp()
