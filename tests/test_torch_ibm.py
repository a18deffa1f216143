"""The port's immersed-boundary slice (pynama_tpu_torch ibm/, cases/ibm.py,
AdaptiveStepper, Problem's device shuttles) against the JAX package, on
the CPU in float64, with the same numpy inputs through both.

Tolerances: support tables bitwise (node ids) and 1e-14 (weights, absolute:
each is a kernel value <= 1); operators (H, S, C, the corrections) 1e-12
relative; transients 1e-9 relative on the fields and force histories, with
the same accepted steps and times. Every case of tests/test_ibm.py has its
parity case here or in tests/test_torch_ibm_runs.py (the short
transients, in a file of their own so that the test workers share them),
at meshes cut to <= 16^2 (3D 8x6x6) and <= 3 steps.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pynama_tpu.cases.ibm import ImmersedBoundaryStatic as JStat
from pynama_tpu.ibm import bodies as JB
from pynama_tpu.ibm import interpolation as JI
from pynama_tpu.mesh import BoxMesh as JBoxMesh
from pynama_tpu.solver import timestep as JT
from pynama_tpu_torch import run_case as trc
from pynama_tpu_torch.cases import ibm as tibm
from pynama_tpu_torch.cases import problem as tproblem
from pynama_tpu_torch.cases.ibm import ImmersedBoundaryDynamic as TDyn
from pynama_tpu_torch.cases.ibm import ImmersedBoundaryStatic as TStat
from pynama_tpu_torch.ibm import bodies as TB
from pynama_tpu_torch.ibm import interpolation as TI
from pynama_tpu_torch.mesh import BoxMesh as TBoxMesh
from pynama_tpu_torch.solver import timestep as TT

from test_ibm import ibm_config

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
OP_RTOL = 1e-12
RUN_RTOL = 1e-9
HISTORIES = ("times", "dt", "steps", "cd", "cl", "cd_phys", "cl_phys")


def sphere_config(nelem=(8, 6, 6), max_steps=2):
    """tests/test_ibm.py's 3D sphere case, mesh cut to `nelem`."""
    return {
        "name": "ibm-sphere", "save-n-steps": 10,
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": 3, "box-mesh": {
            "nelem": list(nelem), "lower": [-3, -3, -3],
            "upper": [3, 3, 3]}},
        "time-solver": {"start-time": 0, "end-time": 0.5,
                        "max-steps": max_steps},
        "boundary-conditions": {"uniform": {"velocity": [1.0, 0.0, 0.0]}},
        "initial-conditions": {"vorticity": [0, 0, 0]},
        "bodies": [{"type": "sphere", "radius": 0.5, "center": [0, 0, 0]}],
    }


def circle_tables(ngl, nelem):
    """The same circle on the same mesh through both packages: (JAX ops,
    nodes, w), (port ops, nodes, w), mesh, body."""
    jm = JBoxMesh.create(ngl, (nelem, nelem), [-3, -3], [3, 3])
    tm = TBoxMesh.create(ngl, (nelem, nelem), [-3, -3], [3, 3])
    body = TB.Circle(radius=0.5)
    body.create(tm.node_separation())
    xy = body.coordinates()
    jops = JI.make_ibm_ops(jm, body.dl, dtype=np.float64)
    tops = TI.make_ibm_ops(tm, body.dl, **F64)
    jn, jw = JI.support_tables(jops, xy)
    tn, tw = TI.support_tables(tops, torch.as_tensor(xy))
    return (jops, jn, jw), (tops, tn, tw), tm, body


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def assert_runs_match(pt, pj, tt, tj, st, sj):
    assert st == sj > 0 and abs(tt - tj) <= 1e-12 * max(1.0, abs(tj))
    for k in ("vort", "vel"):
        assert rel(getattr(pt, k).numpy(), getattr(pj, k)) <= RUN_RTOL, k
    for k in HISTORIES:
        a = np.asarray(pt.history[k], dtype=np.float64)
        b = np.asarray(pj.history[k], dtype=np.float64)
        assert a.shape == b.shape and len(a) > 0, k
        if k in ("times", "steps"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert rel(a, b) <= RUN_RTOL, (k, rel(a, b))


def run_pair(cfg, jcls, tcls, dt0=1e-3, **opts):
    pj = jcls(cfg, **opts)
    pj.setUp()
    tj, sj = pj.start_solver(dt0=dt0)
    pt = tcls(cfg, **F64, **opts)
    pt.setUp()
    tt, st = pt.start_solver(dt0=dt0)
    return pt, pj, tt, tj, st, sj


# ------------------------------------------------------------------ bodies
@pytest.mark.parametrize("name", ["linear", "threeGrid", "fourGrid"])
def test_kernels_partition_of_unity(name):
    """Each kernel sums to 1 over the integer grid for any offset, and
    equals the JAX package's kernel."""
    for frac in (0.0, 0.25, 0.5, 0.77):
        r = np.abs(np.arange(-4, 5) + frac)
        got = TB.KERNELS[name](torch.as_tensor(r)).numpy()
        want = np.asarray(JB.KERNELS[name](jnp.asarray(r)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
        assert abs(got.sum() - 1.0) < 1e-12, (name, frac, got.sum())
    assert TB.KERNEL_SUPPORT == JB.KERNEL_SUPPORT


@pytest.mark.parametrize("kind,cfg", [
    ("circle", {"type": "circle", "radius": 0.7, "center": [0.1, -0.2]}),
    ("line", {"type": "line", "center": [-1.0, 0.5]}),
    ("box", {"type": "box", "center": [0.3, 0.0]}),
    ("sphere", {"type": "sphere", "radius": 0.5, "center": [0, 0, 0]}),
])
def test_bodies_match(kind, cfg):
    """Shapes, spacing, kinematics, forces and ref_length against the JAX
    package (host numpy on both sides: equal bit for bit)."""
    dim = 3 if kind == "sphere" else 2
    cfgs = [dict(cfg, vel="dynamic")] if dim == 2 else [cfg]
    tb, jb = TB.BodiesContainer(cfgs, dim), JB.BodiesContainer(cfgs, dim)
    for b in (tb, jb):
        b.create_bodies(0.11)
        b.set_vel_ref(0.2)
        b.update_parameters(0.37)
    np.testing.assert_array_equal(tb.coordinates(), jb.coordinates())
    np.testing.assert_array_equal(tb.velocities(), jb.velocities())
    assert (tb.dl, tb.n_nodes, tb.ref_length, tb.is_moving) == \
        (jb.dl, jb.n_nodes, jb.ref_length, jb.is_moving)
    flux = np.random.default_rng(3).standard_normal((tb.n_nodes, dim))
    assert tb.compute_force(flux, 0.7) == jb.compute_force(flux, 0.7)


# ---------------------------------------------------------------- tables
@pytest.mark.parametrize("ngl", [3, 5])
def test_support_tables_match(ngl):
    """Node ids equal, weights within 1e-14, each row summing to 1 (the
    kernels act in index space) and, on the uniform ngl=3 grid, a zero
    first moment (tests/test_ibm.py::test_h_rows_conserve)."""
    nelem = 16 if ngl == 3 else 8          # matched resolution
    (jops, jn, jw), (tops, tn, tw), tm, body = circle_tables(ngl, nelem)
    assert tn.dtype == torch.int64 and tops.kside == jops.kside
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(tw.sum(dim=1).numpy(), 1.0, atol=1e-12)
    if ngl == 3:
        coords = tm.coords[tn.numpy()]
        xy = body.coordinates()
        for d in range(2):
            m1 = (tw.numpy() * (coords[:, :, d] - xy[:, d:d + 1])).sum(1)
            np.testing.assert_allclose(m1, 0.0, atol=1e-9)


def test_support_counts():
    """Every Lagrangian point finds at least a 3x3 live stencil and at most
    the full window, with the JAX package's counts."""
    (jops, jn, jw), (tops, tn, tw), _, _ = circle_tables(3, 16)
    active = (tw > 0).sum(dim=1).numpy()
    np.testing.assert_array_equal(active, (np.asarray(jw) > 0).sum(axis=1))
    assert active.min() >= 9 and active.max() <= tops.kside ** 2


def test_interp_spread_adjoint():
    """H and S against the JAX package's, and S = H^T * (dl h):
    <Hv, f> * dl h == <v, Sf>."""
    (jops, jn, jw), (tops, tn, tw), tm, body = circle_tables(3, 16)
    rng = np.random.default_rng(0)
    v = rng.standard_normal((tm.n_nodes, 2))
    f = rng.standard_normal((body.n_nodes, 2))
    Hv = TI.interp_H(tops, tn, tw, torch.as_tensor(v)).numpy()
    Sf = TI.spread_S(tops, tn, tw, torch.as_tensor(f), tm.n_nodes).numpy()
    assert rel(Hv, JI.interp_H(jops, jn, jw, v)) <= OP_RTOL
    assert rel(Sf, JI.spread_S(jops, jn, jw, f, tm.n_nodes)) <= OP_RTOL
    lhs = (Hv * f).sum() * float(tops.dl) * float(tops.h)
    np.testing.assert_allclose(lhs, (v * Sf).sum(), rtol=1e-12)


@pytest.mark.parametrize("moved", [0.0, 0.137])
def test_spread_repeatable(moved):
    """spread_S is bitwise repeatable (a gather and a sum through the
    spread plan, no scatter-add), at the body's start and moved off the
    grid's symmetry, and the plan lists each touched node's slots."""
    (_, jn, _), (tops, tn, tw), tm, body = circle_tables(3, 16)
    xy = torch.as_tensor(body.coordinates() + moved)
    tn, tw = TI.support_tables(tops, xy)
    f = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (body.n_nodes, 2)))
    a = TI.spread_S(tops, tn, tw, f, tm.n_nodes)
    b = TI.spread_S(tops, tn, tw, f, tm.n_nodes, TI.spread_plan(tn))
    assert torch.equal(a, b)
    plan = TI.spread_plan(tn)
    np.testing.assert_array_equal(plan.uniq.numpy(), np.unique(tn.numpy()))
    flat = tn.reshape(-1).numpy()
    for u, row in zip(plan.uniq.numpy(), plan.slots.numpy()):
        live = row[row < flat.size]
        np.testing.assert_array_equal(live, np.flatnonzero(flat == u))


def test_normal_core_routes_match():
    """normal_core (the eq-tensor einsum) against normal_core_spgemm (the
    host SpGEMM) and both against the JAX package's."""
    (jops, jn, jw), (tops, tn, tw), _, _ = circle_tables(3, 16)
    C = TI.normal_core(tops, tn, tw).numpy()
    Cs = TI.normal_core_spgemm(tops, tn, tw)
    assert rel(C, np.asarray(JI.normal_core(jops, jn, jw))) <= OP_RTOL
    assert rel(Cs, JI.normal_core_spgemm(jops, jn, jw)) <= OP_RTOL
    assert rel(Cs, C) <= OP_RTOL
    np.testing.assert_allclose(C, C.T, rtol=0, atol=1e-15)


def test_corrections_match():
    """correction (Cholesky) and correction_cg (matrix-free CG) against
    the JAX package's: the same flux, the CG's iterate and count equal,
    and the two routes agree."""
    (jops, jn, jw), (tops, tn, tw), tm, body = circle_tables(3, 16)
    rng = np.random.default_rng(2)
    v = rng.standard_normal((tm.n_nodes, 2))
    bv = np.tile([0.0, 0.3], (body.n_nodes, 1))
    f0 = 0.1 * rng.standard_normal((body.n_nodes, 2))
    C = TI.normal_core(tops, tn, tw)
    chol = torch.linalg.cholesky(C)
    jchol = jnp.linalg.cholesky(JI.normal_core(jops, jn, jw))
    corr, flux = TI.correction(tops, tn, tw, chol, torch.as_tensor(v),
                               torch.as_tensor(bv), tm.n_nodes)
    jcorr, jflux = JI.correction(jops, jn, jw, jchol, v, bv, tm.n_nodes)
    assert rel(flux.numpy(), jflux) <= OP_RTOL
    assert rel(corr.numpy(), jcorr) <= OP_RTOL
    ccorr, cflux, (it, rr) = TI.correction_cg(
        tops, tn, tw, torch.as_tensor(v), torch.as_tensor(bv),
        torch.as_tensor(f0), tm.n_nodes, rtol=1e-12)
    jccorr, jcflux, (jit, jrr) = JI.correction_cg(
        jops, jn, jw, v, bv, f0, tm.n_nodes, rtol=1e-12)
    assert int(it) == int(jit) > 0 and float(rr) <= 1e-11
    assert rel(cflux.numpy(), jcflux) <= OP_RTOL
    assert rel(ccorr.numpy(), jccorr) <= OP_RTOL
    assert rel(cflux.numpy(), flux.numpy()) <= 1e-10
    # the corrected field interpolates to the body velocity
    Hv = TI.interp_H(tops, tn, tw, torch.as_tensor(v) + corr).numpy()
    np.testing.assert_allclose(Hv, bv, atol=1e-12)


# ------------------------------------------------------------ time stepper
def test_adaptive_stepper_scalar_ode():
    """dy/dt = -50 (y - cos t) from a dt0 too large, so steps are rejected:
    the same accepted times, dts and states as the JAX package's stepper,
    and the non-finite quartering and dt_min error."""
    def rhs_t(t, y, aux):
        return -50.0 * (y - np.cos(t)), aux

    def rhs_j(t, y, aux):
        return -50.0 * (y - jnp.cos(t)), aux

    st = TT.AdaptiveStepper(rhs_t, atol=1e-8, rtol=1e-8)
    sj = JT.AdaptiveStepper(rhs_j, atol=1e-8, rtol=1e-8, jit=False)
    st.dt = sj.dt = 0.2
    yt, yj = torch.tensor([1.0], dtype=torch.float64), jnp.asarray([1.0])
    t_t = t_j = 0.0
    for _ in range(6):
        t_t, yt, _ = st.step(t_t, yt, None, t_max=0.5)
        t_j, yj, _ = sj.step(t_j, yj, None, t_max=0.5)
        assert abs(t_t - t_j) <= 1e-15 and abs(st.dt - sj.dt) <= 1e-12
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-13)
    assert t_t <= 0.5
    calls = {}
    for name, mod in (("torch", TT), ("jax", JT)):
        calls[name] = []

        def nan_attempt(t, dt, y, aux, log=calls[name], mod=mod):
            log.append(dt)
            return mod.StepResult(y=y, enorm=float("nan"), aux=aux)

        s = mod.AdaptiveStepper(None, attempt=nan_attempt, dt_min=1e-3)
        s.dt = 0.1
        with pytest.raises(RuntimeError, match="non-finite"):
            s.step(0.0, yt, None)
    assert calls["torch"] == calls["jax"]
    np.testing.assert_allclose(calls["torch"],
                               [0.1, 0.025, 0.00625, 0.0015625])


def test_adaptive_stepper_ibm_run():
    """AdaptiveStepper inside a cut-down IBM run at the default tolerance
    from a dt0 whose second step is rejected: the same accepted times and
    controller dts as the JAX package's run."""
    cfg = ibm_config(nelem=8, max_steps=3, end=5.0)
    runs = {}
    for name, cls, kw in (("jax", JStat, {}), ("torch", TStat, F64)):
        p = cls(cfg, solver="direct", **kw)
        p.setUp()
        stages = []
        rhs = p.rhs
        # counts the port's stages (the JAX package's rhs runs traced)
        p.rhs = lambda t, y, aux: stages.append(t) or rhs(t, y, aux)
        t, steps = p.start_solver(dt0=1.0)
        runs[name] = (t, steps, p.history, len(stages))
    (tt, st, ht, at), (tj, sj, hj, _) = runs["torch"], runs["jax"]
    assert st == sj == 3 and at > 8 * st       # a rejection happened
    assert abs(tt - tj) <= 1e-12
    np.testing.assert_allclose(ht["dt"], hj["dt"], rtol=1e-9)
    np.testing.assert_allclose(ht["times"], hj["times"], rtol=1e-12)


# --------------------------------------------------------- device shuttles
def test_device_shuttles_match_host(monkeypatch):
    """Problem's device gathers (to_local, _to_global_dev) equal the host
    ops/local.py shuttles bit for bit, and an RK stage of an IBM case on the engine route (Problem.rhs)
    copies no field through the host: the host shuttles are made to raise
    while it runs, and it gives the same f as before."""
    p = TDyn(ibm_config(nelem=6, vel="dynamic"), solver="cg",
             cg_rtol=1e-12, **F64)
    p.setUp()
    rng = np.random.default_rng(4)
    vort = torch.as_tensor(rng.standard_normal((p.mesh.n_nodes, 1)))
    vel = torch.as_tensor(rng.standard_normal((p.mesh.n_nodes, 2)))
    for x in (vort, vel, vel.numpy()):
        want = tproblem.L.to_local(p.mesh, tproblem.host_array(x))
        np.testing.assert_array_equal(p.to_local(x).numpy(), want)
    vort_s, vel_s = p.solve_kle(vort, vel, 0.0)
    for x, c in ((vort_s, 1), (vel_s, 2)):
        xl = p.to_local(x)
        got = p._to_global_dev(xl, c)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), p.to_global(xl, c))
    f0, _ = p.rhs(0.01, vort, vel)

    def no_host(*a, **k):
        raise AssertionError("a field went through the host")

    monkeypatch.setattr(tproblem, "host_array", no_host)
    monkeypatch.setattr(tproblem.L, "to_local", no_host)
    monkeypatch.setattr(tproblem.L, "to_global", no_host)
    f1, _ = p.rhs(0.01, vort, vel)
    assert torch.equal(f0, f1)


# ------------------------------------------------------------ entry points
def test_make_problem_picks_the_ibm_class():
    """run_case.make_problem: bodies -> ImmersedBoundaryStatic, a body with
    vel dynamic -> ImmersedBoundaryDynamic (pynama_tpu/run_case.py:43-52);
    with ndev > 1 the IBM class runs sharded and ends on the
    JAX package's 2-device run: the same steps, fields and forces to
    RUN_RTOL."""
    for vel, cls in (("static", TStat), ("dynamic", TDyn)):
        p = trc.make_problem(ibm_config(nelem=4, vel=vel), **F64)
        assert type(p) is cls
    cfg = ibm_config(nelem=4)
    p = trc.make_problem(cfg, ndev=2, solver="cg", **F64)
    p.setUp()
    t, steps = p.start_solver()
    pj = JStat(cfg, ndev=2, solver="cg")
    pj.setUp()
    tj, sj = pj.start_solver()
    assert steps == sj == 3 and len(p.rank_stats) == 2
    assert rel(p.vel.numpy(), np.asarray(pj.vel)) <= RUN_RTOL
    assert rel(np.asarray(p.history["cd"]),
               np.asarray(pj.history["cd"])) <= RUN_RTOL
    assert tibm.ImmersedBoundaryStatic is TStat
