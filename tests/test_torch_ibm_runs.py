"""The IBM short transients of tests/test_ibm.py through the port and the
JAX package, float64 on the CPU: fields and force histories within 1e-9
relative, the same accepted steps and times (helpers and tolerances in
tests/test_torch_ibm.py); the cd_phys sign as a strict xfail.
"""
import numpy as np
import pytest
import torch

from pynama_tpu.cases.ibm import ImmersedBoundaryDynamic as JDyn
from pynama_tpu.cases.ibm import ImmersedBoundaryStatic as JStat
from pynama_tpu_torch.cases.ibm import ImmersedBoundaryDynamic as TDyn
from pynama_tpu_torch.cases.ibm import ImmersedBoundaryStatic as TStat
from pynama_tpu_torch.ibm import interpolation as TI

from test_ibm import ibm_config
from test_torch_ibm import (F64, RUN_RTOL, assert_runs_match, rel, run_pair,
                            sphere_config)

torch.set_num_threads(1)


def test_static_cylinder_short_run():
    """tests/test_ibm.py's static cylinder, 3 steps (direct solve): the
    JAX package's fields, force history and steps; the body velocity (0)
    enforced at the Lagrangian points."""
    pt, pj, *r = run_pair(ibm_config(nelem=16, max_steps=3), JStat, TStat,
                          solver="direct")
    assert_runs_match(pt, pj, *r)
    Hv = TI.interp_H(pt.ibm_ops, pt.nodes_tab, pt.w_tab, pt.vel).numpy()
    assert np.abs(Hv).max() < 1e-12
    assert set(pt.setup_phases) >= {"ibm_bodies", "ibm_tables", "ibm_core",
                                    "ibm_factor"}


@pytest.mark.parametrize("solver", ["direct", "cg"])
def test_dynamic_cylinder_short_run(solver):
    """tests/test_ibm.py's moving cylinder, 2 steps, through the global
    rhs on the direct solve and on the engine's CG (the device
    shuttles): the JAX package's fields, histories and correction CG."""
    opts = dict(solver=solver)
    if solver == "cg":
        opts.update(cg_rtol=1e-13, cg_maxiter=4000)
    pt, pj, *r = run_pair(ibm_config(nelem=12, vel="dynamic", max_steps=2),
                          JDyn, TDyn, **opts)
    assert_runs_match(pt, pj, *r)
    assert pt.solver_method == solver
    assert len(pt.corr_log) == 3            # the start and each step
    assert all(rr <= 1e-11 for _, rr in pt.corr_log)
    assert rel(pt._flux.numpy(), pj._flux) <= RUN_RTOL


def test_cylinder_drag_ngl_invariance():
    """tests/test_ibm.py's ngl invariance at its own size (both 49x49 grid
    points; end-time clamping leaves 2 steps): the port's drag equals the
    JAX package's at each ngl, and ngl=5 is within 5% of ngl=3. This one
    case keeps the reference's 24^2 mesh: at 16^2 vs 8^2 the two drags
    differ by 13% in both packages (the resolution's error, not the
    port's)."""
    cds = {}
    for ngl, nelem in ((3, 24), (5, 12)):
        cfg = ibm_config(nelem=nelem, max_steps=6, end=0.03)
        cfg["domain"]["ngl"] = ngl
        out = []
        for cls, kw in ((JStat, {}), (TStat, F64)):
            p = cls(cfg, solver="direct", **kw)
            p.setUp()
            p.start_solver(dt0=5e-3, atol=1e6, rtol=1e6)
            out.append(p.history["cd"][-1][0])
        assert abs(out[1] - out[0]) <= RUN_RTOL * abs(out[0])
        cds[ngl] = out[1]
    assert abs(cds[5] - cds[3]) <= 0.05 * abs(cds[3]), cds


def test_sphere_3d_short_run():
    """tests/test_ibm.py's 3D sphere (mesh cut to 8x6x6) on the engine's
    CG through the device shuttles: the JAX package's fields, histories
    and steps; the body velocity enforced."""
    pt, pj, *r = run_pair(sphere_config(), JStat, TStat, solver="cg",
                          cg_rtol=1e-13, cg_maxiter=4000)
    assert_runs_match(pt, pj, *r)
    assert pt.dim == 3 and pt.body.n_nodes > 20
    L, K = pt.nodes_tab.shape
    assert L * L * K * K <= 2 ** 27          # the eq-tensor route
    Hv = TI.interp_H(pt.ibm_ops, pt.nodes_tab, pt.w_tab, pt.vel).numpy()
    assert np.abs(Hv).max() < 1e-12


@pytest.mark.xfail(strict=True, reason="cd_phys mirrors the JAX package's "
                   "sign, the momentum given to the fluid: a known fault of "
                   "the reference (ROADMAP, known faults)")
def test_cd_phys_is_the_drag_on_the_body():
    """Uniform flow past a fixed cylinder drags the body downstream: a
    physical drag coefficient is positive."""
    p = TStat(ibm_config(nelem=12, max_steps=3), solver="direct", **F64)
    p.setUp()
    p.start_solver(dt0=1e-3)
    assert p.history["cd_phys"][-1] > 0
