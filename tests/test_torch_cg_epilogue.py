"""pcg's one loop over a CGState (solver/cg.py, ops/cg_epilogue.py,
csrc/cg_epilogue.cu) and which route each caller takes.

On the CPU every route runs the plain steps. The plain steps agree with
the JAX package's pcg in f64, and a system given as a MaskedSystem gives
bitwise the x, iters, residual and loop_applies of the same system given
generically: on 2D and 3D box meshes under every preconditioner, on a
dense system stopped early inside a check block, at the maxiter cap and
with b == 0. The route rule: the unsharded engine's masked system is
"fused" (the kernels on a card); the sharded engine (its dots need a psum),
the global layout (solver/kle.py) and the IBM correction CGs are "eager"
(plain steps everywhere). `cg.fused_share` reads the engine's `kle.solve`
attribute, which pcg reports.

Tests marked `card` compare the kernels with the plain steps and the
kernels' solve with the plain steps' on an NVIDIA card, and skip without
one. The file imports no JAX at module level; on the card run them without
the JAX-loading conftest: `python -m pytest --noconftest -p no:cacheprovider
-m card tests/test_torch_cg_epilogue.py`.
"""
import dataclasses
import os
import re
import sys
import time
import types

import numpy as np
import pytest
import torch

from pynama_tpu_torch.cases import Problem
from pynama_tpu_torch.engine import local_engine as LE
from pynama_tpu_torch.ops import cg_epilogue as E
from pynama_tpu_torch.solver import cg as CG
from pynama_tpu_torch.utils.profiling import tracing

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
STEPS = {"cg_pap": E.cg_pap, "cg_xr": E.cg_xr, "cg_rz": E.cg_rz,
         "cg_p": E.cg_p}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def cavity(dim, nelem, ngl):
    lid = [1.0] + [0.0] * (dim - 1)
    walls = ["up", "down", "left", "right"] + (["front", "back"]
                                               if dim == 3 else [])
    return {"name": "cavity",
            "material-properties": {"rho": 1.0, "mu": 0.02},
            "domain": {"ngl": ngl, "box-mesh": {
                "nelem": [nelem] * dim, "lower": [0] * dim,
                "upper": [1] * dim}},
            "time-solver": {"start-time": 0, "end-time": 0.01,
                            "max-steps": 20},
            "boundary-conditions": {"no-slip": {
                w: (lid if w == "up" else [0] * dim) for w in walls}},
            "initial-conditions": {"vorticity": [0] * (1 if dim == 2
                                                       else 3)}}


def problem(dim, nelem, ngl, device="cpu", dtype=torch.float64, **opts):
    kw = dict(solver="cg", cg_rtol=1e-10, cg_maxiter=500)
    kw.update(opts)
    p = Problem(cavity(dim, nelem, ngl), device=device, dtype=dtype, **kw)
    p.setUp()
    return p


def state(p, seed=7):
    """A random local-layout start state, the same for a seed."""
    g = torch.Generator().manual_seed(seed)
    n = p.mesh.n_nodes
    vort = torch.rand((n, p.mesh.dim * 2 - 3), generator=g,
                      dtype=torch.float64) - 0.5
    vel = torch.rand((n, p.mesh.dim), generator=g,
                     dtype=torch.float64) - 0.5
    dt = p.engine_ops.diag.dtype
    return (p.to_local(vort.to(dt).to(p.device)),
            p.to_local(vel.to(dt).to(p.device)))


def generic(system):
    """A MaskedSystem on one rank written out as pcg's generic form takes
    it: A, A0, M_inv and dot."""
    free, inv, d = system.free, system.inv_mult, system.dmask
    con = 1.0 - free
    return dict(A=lambda v: free * system.apply(v),
                A0=lambda v: free * system.apply(free * v) + con * v,
                M_inv=system.precond if d is None else (lambda r: r / d),
                dot=lambda a, c: (a * c * inv).sum())


class Spy:
    """Stands in for local_engine's pcg: runs the solve as the engine asked
    (`again` more times) and, on one rank, again with the same system given
    generically; keeps every result."""

    def __init__(self, again=0):
        self.calls, self.again = [], again

    def __call__(self, system, b, x0, **kw):
        res = CG.pcg(system, b, x0, **kw)
        row = {"system": system, "res": res, "args": (b, x0, kw),
               "more": [CG.pcg(system, b, x0, **kw)
                        for _ in range(self.again)]}
        if system.reduce is None:
            row["generic"] = CG.pcg(b=b, x0=x0, **generic(system), **kw)
        self.calls.append(row)
        return res


def same(a: CG.CGResult, b: CG.CGResult) -> bool:
    return (torch.equal(a.x, b.x) and torch.equal(a.iters, b.iters)
            and a.iters.dtype == b.iters.dtype
            and torch.equal(a.residual, b.residual)
            and a.loop_applies == b.loop_applies)


# ------------------------------ CPU: a masked system is the generic one
@pytest.mark.parametrize("pc", ["jacobi", "fdm", "schwarz"])
@pytest.mark.parametrize("dim,nelem", [(2, 3), (3, 2)])
def test_engine_solves_bitwise_eager(dim, nelem, pc, monkeypatch):
    """Both KLE stages of one rhs: the engine's MaskedSystem ("fused")
    gives the fields of the same system given generically ("eager") bit
    for bit."""
    p = problem(dim, nelem, 3, pc=pc)
    spy = Spy()
    monkeypatch.setattr(LE, "pcg", spy)
    LE.rhs_local(p.engine_ops, 0.0, *state(p))
    assert len(spy.calls) == 2
    for row in spy.calls:
        system = row["system"]
        assert isinstance(system, E.MaskedSystem) and system.reduce is None
        assert (system.dmask is not None) == (pc == "jacobi")
        if pc != "jacobi":                  # Precond's loop form
            assert not isinstance(system.precond, LE.Precond)
        assert (row["res"].epilogue, row["generic"].epilogue) \
            == ("fused", "eager")
        assert same(row["res"], row["generic"])
        assert 0 < int(row["res"].iters) <= row["res"].loop_applies


@pytest.mark.parametrize("pc", ["jacobi", "fdm", "schwarz"])
@pytest.mark.parametrize("dim,nelem", [(2, 3), (3, 2)])
def test_precond_loop_form_is_m_inv_on_loop_vectors(dim, nelem, pc):
    """Precond.loop equals the full M_inv on vectors that are zero on the
    constrained dofs, and keeps them zero there; Jacobi's divisor is
    dmask."""
    p = problem(dim, nelem, 3, pc=pc)
    ops = p.engine_ops
    g = torch.Generator().manual_seed(5)
    for free, fdm in ((ops.free_fs, ops.fdm_fs), (ops.free_main,
                                                  ops.fdm_main)):
        P = LE.preconditioner(ops, free, fdm)
        assert isinstance(P, LE.Precond)
        assert (P.dmask is not None) == (pc == "jacobi")
        assert (P.con is None) == (pc == "jacobi")    # no vector kept
        r = free * (torch.rand(free.shape, generator=g,
                               dtype=free.dtype) - 0.5)
        z = P.loop(r)
        assert torch.equal(z, P(r))
        assert not ((1.0 - free) * z).any()
        if pc == "jacobi":
            assert torch.equal(z, r / P.dmask)


def dense_system(n=60, n_con=7, seed=3, cond=1e4):
    """A masked SPD system as the engine builds one, on flat vectors: b,
    x0, the MaskedSystem (Jacobi) and its generic form (A, A0, M_inv,
    dot), and the arrays K, free, inv."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    K = torch.tensor((Q * np.geomspace(1.0, cond, n)) @ Q.T)
    free = torch.ones(n, dtype=torch.float64)
    free[torch.tensor(rng.choice(n, size=n_con, replace=False))] = 0.0
    con = 1.0 - free
    vel = torch.tensor(rng.standard_normal(n))
    rhs = torch.tensor(rng.standard_normal(n))
    inv = torch.full((n,), 0.5, dtype=torch.float64)   # keeps A symmetric
    vc = con * vel
    system = E.MaskedSystem(apply=lambda v: K @ v, free=free, inv_mult=inv,
                            precond=free * torch.diagonal(K) + con)
    return dict(b=free * (rhs - K @ vc) + vc, x0=free * vel + vc,
                system=system, K=K, free=free, inv=inv, **generic(system))


def with_precond(s, M_inv):
    """s with the preconditioner M_inv (a callable) in both forms."""
    return {**s, "M_inv": M_inv,
            "system": dataclasses.replace(s["system"], precond=M_inv)}


def solve_both(s, **kw):
    """(masked, generic): pcg of s's system in its two forms."""
    generic_ = CG.pcg(s["A"], s["b"], s["x0"], M_inv=s["M_inv"],
                      dot=s["dot"], A0=s["A0"], **kw)
    masked = CG.pcg(s["system"], s["b"], s["x0"], **kw)
    return masked, generic_


@pytest.mark.parametrize("rtol,maxiter,want", [
    (1e-10, 500, "early"),       # converged inside a check block
    (1e-14, 13, "cap"),          # stopped by maxiter, not a multiple of 8
    (1e-10, 500, "zero_b"),      # b == 0: live false, x == 0
])
def test_dense_loop_bitwise_eager(rtol, maxiter, want):
    s = dense_system()
    if want == "zero_b":
        s["b"] = torch.zeros_like(s["b"])
    x0 = s["x0"].clone()
    masked, generic_ = solve_both(s, rtol=rtol, maxiter=maxiter)
    assert same(masked, generic_)
    assert torch.equal(s["x0"], x0)          # x0 is not written
    it, n = int(masked.iters), masked.loop_applies
    if want == "early":
        assert 0 < it < n and it % CG.CHECK_EVERY != 0
    elif want == "cap":
        assert it == n == maxiter
    else:
        assert it == n == 0 and not masked.x.any()


def test_eager_preconditioner_route_bitwise():
    """With a callable preconditioner (no dmask) the loop takes cg_rz:
    still bitwise."""
    s = dense_system(seed=4)
    s = with_precond(s, s["M_inv"])
    masked, generic_ = solve_both(s, rtol=1e-10, maxiter=500)
    assert same(masked, generic_) and int(masked.iters) > 0


def test_identity_preconditioner_keeps_r():
    """M_inv = identity makes the prologue's p and r one tensor; the
    steps keep them apart."""
    s = with_precond(dense_system(seed=5), lambda r: r)
    masked, generic_ = solve_both(s, rtol=1e-10, maxiter=500)
    assert same(masked, generic_)


@pytest.mark.parametrize("pc", ["jacobi", "identity"])
def test_plain_steps_match_the_jax_pcg(pc):
    """Both forms of the dense system against the JAX package's pcg with
    the same operator, preconditioner and weighted dot, in f64, on a
    spectrum of condition 1e2 (at 1e4 CG runs past n iterations, where
    the order of summation moves the count): the same iteration count
    within one and the same iterate to 1e-9, as
    test_torch_engine.py's generic pcg against the JAX package's."""
    import jax.numpy as jnp
    from pynama_tpu.solver.cg import pcg as jax_pcg
    s = dense_system(seed=6, cond=1e2)
    if pc == "identity":
        s = with_precond(s, lambda r: r)
    K, free, inv = (jnp.asarray(s[k].numpy()) for k in ("K", "free", "inv"))
    dmask = jnp.asarray(s["system"].precond.numpy()) if pc == "jacobi" \
        else None
    want = jax_pcg(lambda v: free * (K @ v), jnp.asarray(s["b"].numpy()),
                   jnp.asarray(s["x0"].numpy()),
                   M_inv=None if dmask is None else (lambda r: r / dmask),
                   rtol=1e-10, maxiter=500,
                   dot=lambda a, c: jnp.sum(a * c * inv),
                   A0=lambda v: free * (K @ (free * v)) + (1.0 - free) * v)
    for res in solve_both(s, rtol=1e-10, maxiter=500):
        assert abs(int(res.iters) - int(want.iters)) <= 1
        assert rel(res.x, torch.as_tensor(np.array(want.x))) <= 1e-9
        assert res.loop_applies >= int(res.iters) > 0


@pytest.mark.parametrize("given", ["M_inv", "dot", "A0"])
def test_masked_system_takes_no_generic_callables(given):
    s = dense_system()
    with pytest.raises(TypeError, match="MaskedSystem"):
        CG.pcg(s["system"], s["b"], s["x0"], **{given: s[given]})


# ------------------------------------------------------------ the steps
def cpu_state(n=40, dtype=torch.float64, dmask=True):
    g = torch.Generator().manual_seed(1)
    v = [torch.rand(n, generator=g, dtype=dtype) + 0.5 for _ in range(6)]
    system = E.MaskedSystem(apply=None, free=v[0], inv_mult=v[1],
                            precond=v[2] if dmask else (lambda r: r))
    s = lambda x: torch.tensor(x, dtype=dtype)
    st = E.CGState(system, v[3], v[4], v[5], s(2.0), s(3.0), s(1e-8),
                   torch.tensor(True), torch.tensor(True),
                   torch.tensor(0), 100)
    return st, v


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "strides",
                                 "type"])
def test_steps_raise_on_wrong_input(step, bad):
    st, v = cpu_state()
    y = {"dtype": v[0].float(), "shape": v[0][:-1].clone(),
         "device": torch.empty(40, dtype=torch.float64, device="meta"),
         "strides": torch.rand(80, dtype=torch.float64)[::2],
         "type": v[0].numpy()}[bad]
    with pytest.raises(TypeError if bad in ("dtype", "type")
                       else ValueError):
        STEPS[step](st, y)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "shape", "device"])
def test_state_raises_on_wrong_input(bad):
    n = 16
    f = lambda dt=torch.float64, m=n: torch.ones(m, dtype=dt)
    vecs = dict(free=f(), inv_mult=f(), precond=f())
    x0, r, z = f(), f(), f()
    if bad == "dtype":
        x0, r, z = f(torch.int64), f(torch.int64), f(torch.int64)
        vecs = {k: f(torch.int64) for k in vecs}
    elif bad == "mixed":
        vecs["precond"] = f(torch.float32)
    elif bad == "shape":
        vecs["inv_mult"] = f(m=n + 1)
    else:
        x0, r, z = (torch.ones(n, dtype=torch.float64, device="meta")
                    for _ in range(3))
    s = torch.tensor(1.0, dtype=torch.float64)
    with pytest.raises(TypeError if bad in ("dtype", "mixed")
                       else ValueError):
        E.CGState(E.MaskedSystem(apply=None, **vecs), x0, r, z, s, s, s,
                  torch.tensor(True), torch.tensor(True), torch.tensor(0),
                  10)


def test_cg_p_without_z_needs_dmask():
    st, _ = cpu_state(dmask=False)
    with pytest.raises(ValueError, match="dmask"):
        E.cg_p(st)


def test_cpu_steps_count_no_launches():
    before = {k: fn.launches for k, fn in STEPS.items()}
    st, v = cpu_state()
    ap = E.cg_pap(st, v[0].clone())
    E.cg_xr(st, ap)
    E.cg_p(st)
    E.cg_rz(st, v[1].clone())
    assert {k: fn.launches for k, fn in STEPS.items()} == before


# ----------------------------------------------------- the route rule
def record_states(monkeypatch):
    """Every CGState pcg makes from now on, in a list."""
    seen, make = [], E.CGState

    def spy(*args, **kw):
        seen.append(make(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(E, "CGState", spy)
    return seen


def routes(states):
    """(fused, kernels, masked) of each state."""
    return [(st.fused, st.cuda, st.free is not None) for st in states]


def test_unsharded_engine_runs_fused(monkeypatch):
    """A masked system on one rank: "fused", the kernels' route (the plain
    steps on the CPU)."""
    p = problem(2, 3, 3)
    states = record_states(monkeypatch)
    tr = tracing()
    try:
        LE.rhs_local(p.engine_ops, 0.0, *state(p))
    finally:
        tr.stop()
    solves = [r for r in tr.records() if r.name == "kle.solve"]
    assert [r.attrs["epilogue"] for r in solves] == ["fused", "fused"]
    assert routes(states) == [(True, False, True)] * 2


class FakeComm:
    """Two ranks' collectives as one rank sees them when its neighbours
    send zeros: enough to drive the sharded route's branches."""
    size = 2

    def psum(self, x):
        return x

    def exchange(self, a, b):
        return torch.zeros_like(a), torch.zeros_like(b)


def test_sharded_engine_keeps_the_eager_loop(monkeypatch):
    """A masked system whose dots need a psum: "eager", plain steps."""
    p = problem(2, 3, 3)
    ops = dataclasses.replace(p.engine_ops, comm=FakeComm(), cg_maxiter=9)
    assert LE._sharded(ops)
    spy = Spy()
    monkeypatch.setattr(LE, "pcg", spy)
    states = record_states(monkeypatch)
    tr = tracing()
    try:
        LE.rhs_local(ops, 0.0, *state(p))
    finally:
        tr.stop()
    assert len(spy.calls) == 2
    assert all(row["system"].reduce == ops.comm.psum for row in spy.calls)
    assert [r.attrs["epilogue"] for r in tr.records()
            if r.name == "kle.solve"] == ["eager", "eager"]
    assert routes(states) == [(False, False, True)] * 2


def test_global_layout_keeps_the_eager_loop(monkeypatch):
    """A generic system (solver/kle.py): "eager", plain steps."""
    p = problem(2, 3, 3, engine=False)
    assert p.engine_ops is None
    states = record_states(monkeypatch)
    tr = tracing()
    try:
        p.rhs(0.0, p.vort, p.vel)
    finally:
        tr.stop()
    assert [(r.attrs["method"], r.attrs["epilogue"]) for r in tr.records()
            if r.name == "kle.solve"] == [("cg", "eager")] * 2
    assert routes(states) == [(False, False, False)] * 2


def circle_tables(ndev=None):
    """A cylinder on a 16x16 ngl=3 mesh: (ops, nodes, w, mesh, body), and
    with ndev the rank tables of build_ibm_shard_tables."""
    from pynama_tpu_torch.ibm import interpolation as TI
    from pynama_tpu_torch.ibm.bodies import Circle
    from pynama_tpu_torch.mesh import BoxMesh
    mesh = BoxMesh.create(3, (16, 16), [-3, -3], [3, 3])
    body = Circle(radius=0.5)
    body.create(mesh.node_separation())
    ops = TI.make_ibm_ops(mesh, body.dl, dtype=torch.float64, device="cpu")
    nodes, w = TI.support_tables(ops, torch.as_tensor(body.coordinates()))
    return ops, nodes, w, mesh, body


def test_ibm_correction_cgs_keep_the_eager_loop(monkeypatch):
    """Both IBM correction CGs give pcg generic systems: "eager", plain
    steps."""
    from pynama_tpu_torch.ibm import interpolation as TI
    from pynama_tpu_torch.ibm.sharded import (build_ibm_shard_tables,
                                              correction_cg_local)
    from pynama_tpu_torch.ops import local as TL
    from pynama_tpu_torch.parallel.comm import SlabComm
    seen = []

    def spy(*args, **kw):
        res = pcg(*args, **kw)
        seen.append(res.epilogue)
        return res

    pcg = CG.pcg
    monkeypatch.setattr(CG, "pcg", spy)
    states = record_states(monkeypatch)
    ops, nodes, w, mesh, body = circle_tables()
    rng = np.random.default_rng(3)
    vel = torch.tensor(rng.standard_normal((mesh.n_nodes, 2)))
    bv = torch.tensor(rng.standard_normal((body.n_nodes, 2)))
    _, _, (it, _) = TI.correction_cg(ops, nodes, w, vel, bv,
                                     torch.zeros_like(bv), mesh.n_nodes)
    slots, gw, sw = build_ibm_shard_tables(mesh, nodes.numpy(), w.numpy(),
                                           1)
    vel_l = torch.as_tensor(TL.to_local(mesh, vel.numpy())).reshape(1, -1,
                                                                     18)[0]
    scale = float(ops.dl) * float(ops.h)
    _, _, (it_l, _) = correction_cg_local(
        torch.as_tensor(slots[0]), torch.as_tensor(gw[0]),
        torch.as_tensor(sw[0]), scale, vel_l, bv, torch.zeros_like(bv),
        SlabComm("cpu"))
    assert seen == ["eager", "eager"] and int(it) > 0 and int(it_l) > 0
    assert routes(states) == [(False, False, False)] * 2


# ---------------------------------------------------------- cg.fused_share
def bench_modules():
    for p in (ROOT, BENCH):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness.spec import load_named
    return load_named


def test_fused_share_on_a_fixture_cell(tmp_path):
    load_named = bench_modules()
    from harness.cell import run_cell
    from harness.spec import load_cell
    from pynama_tpu_torch.utils import profiling
    fixture = os.path.join(BENCH, "tests", "fixture")
    cell = load_cell("tiny2d.cg", os.path.join(fixture, "BENCHMARK.json"),
                     fixture)
    extra = {"name": "cg.fused_share", "unit": "%",
             "source": "program_span"}
    cell = dataclasses.replace(cell, per_layer=cell.per_layer + [extra])
    try:
        r = run_cell(cell, 2**31 + 11, 0.5, True,
                     t_start=time.perf_counter(), device="cpu",
                     out_dir=str(tmp_path), log=lambda m: None)
    finally:
        if profiling._ACTIVE is not None:
            profiling._ACTIVE.stop()
    assert r["correct"]
    assert r["metrics"]["cg.fused_share"]["value"] == 100.0
    assert load_named("metrics", "cg.fused_share").SPANS


def fake_trace(attrs):
    from pynama_tpu_torch.utils import profiling
    tr = profiling.Trace()
    for a, b, at in attrs:
        tr.attrs[len(tr.names)] = at
        tr.names.append("kle.solve")
        tr.t0.append(round(a * 1e9))
        tr.t1.append(round(b * 1e9))
        tr.parent.append(-1)
    return tr


def fused_share_rec(trace):
    from harness.spans import Span
    return types.SimpleNamespace(
        spans=[Span("stepper", 0.9, 5.0)], profiled=[],
        prepared={"cg.fused_share": trace}, trace=None, steps=1)


@pytest.mark.parametrize("attrs,want", [
    # a program without the attribute: nothing
    ([{"method": "cg", "loop_applies": 10}], None),
    ([{"method": "cg", "loop_applies": 10, "epilogue": "fused"},
      {"method": "cg", "loop_applies": 30, "epilogue": "eager"},
      {"method": "direct"}], 25.0),
    ([{"method": "cg", "loop_applies": 8, "epilogue": "fused"},
      {"method": "gmres", "loop_applies": 30}], 100.0),
    ([{"method": "direct"}], None),
])
def test_fused_share_reader(attrs, want):
    load_named = bench_modules()
    mod = load_named("metrics", "cg.fused_share")
    rows = [(1.0 + i, 1.5 + i, a) for i, a in enumerate(attrs)]
    rec = fused_share_rec(fake_trace(rows))
    assert mod.read(rec) == want
    # outside the window: nothing read
    rec = fused_share_rec(fake_trace([(6.0, 7.0, a) for a in attrs]))
    assert mod.read(rec) is None


def test_fused_share_without_a_tracer():
    load_named = bench_modules()
    mod = load_named("metrics", "cg.fused_share")
    assert mod.read(fused_share_rec(None)) is None


# -------------------------------------------------------------- on the card
def random_state(dev, dtype, n, dmask, seed=0):
    """A CGState of a masked system on random vectors on dev (and a maker
    of more), run and live true, k = 3: the same values on every device
    for a seed."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda: (torch.rand(n, generator=g, dtype=torch.float64)
                 + 0.5).to(dtype).to(dev)
    free = (torch.rand(n, generator=g) > 0.05).to(dtype).to(dev)
    system = E.MaskedSystem(apply=None, free=free, inv_mult=r(),
                            precond=r() if dmask else (lambda v: v))
    s = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    st = E.CGState(system, r(), r(), r(), s(2.5), s(3.0), s(1e-30),
                   torch.tensor(True, device=dev),
                   torch.tensor(True, device=dev),
                   torch.tensor(3, device=dev), 1000)
    return st, r


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("jacobi", [True, False])
def test_card_kernels_match_plain(card, dtype, jacobi):
    """One iteration's steps at the flagship's vector length (24^3 ngl=4,
    2,654,208 values, and one value more, for the unpacked tail): the
    kernels' vectors and scalars against the plain steps' on the same
    values on the CPU."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for n in (13824 * 192, 13824 * 192 + 1):
        st, r = random_state(card, dtype, n, jacobi)
        ref, r_ref = random_state("cpu", dtype, n, jacobi)
        assert st.cuda and not ref.cuda
        y, zin = r(), r()
        y_ref, z_ref = r_ref(), r_ref()
        counts = {k: fn.launches for k, fn in STEPS.items()}
        ap = E.cg_pap(st, y)
        E.cg_xr(st, ap)
        ap_ref = E.cg_pap(ref, y_ref)
        E.cg_xr(ref, ap_ref)
        if jacobi:
            E.cg_p(st)
            E.cg_p(ref)
        else:
            E.cg_rz(st, zin)
            E.cg_p(st, zin)
            E.cg_rz(ref, z_ref)
            E.cg_p(ref, z_ref)
        torch.cuda.synchronize()
        want = {"cg_pap": 1, "cg_xr": 1, "cg_p": 1, "cg_rz": 0 if jacobi
                else 1}
        assert {k: fn.launches - counts[k] for k, fn in STEPS.items()} \
            == want
        assert rel(ap, ap_ref) <= tol
        for k in ("x", "r", "p"):
            assert rel(getattr(st, k), getattr(ref, k)) <= tol, k
        sf_ref = torch.stack(ref.sf).double()
        assert torch.allclose(st.sf.double().cpu(), sf_ref, rtol=tol,
                              atol=0), (st.sf, sf_ref)
        assert st.si.tolist() == [int(v) for v in ref.si] == [4, 1, 1]


def flagship_spy(card, dtype, pc="jacobi", again=1):
    """One rhs of the 24^3 ngl=4 cavity (the flagship's mesh) on the card
    from a random state, every CG solve run as the engine's masked system
    (the kernels; again more times) and generically (plain steps)."""
    p = problem(3, 24, 4, device=card, dtype=dtype, cg_rtol=1e-6,
                cg_maxiter=1000, pc=pc)
    spy = Spy(again=again)
    orig = LE.pcg
    LE.pcg = spy
    try:
        LE.rhs_local(p.engine_ops, 0.0, *state(p))
    finally:
        LE.pcg = orig
    torch.cuda.synchronize()
    return spy


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_card_fused_solve_matches_eager(card, dtype):
    """Both stages of one rhs on the flagship's mesh: iteration counts
    within 3 % of the plain steps'; the kernels' iterate as close to the
    plain steps' as those come to themselves when their dot products are
    only summed in another order (rounding alone), or within 1e-5 (f32) /
    1e-12 (f64); its true residual no larger; and two kernel runs bitwise
    equal."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    spy = flagship_spy(card, dtype)
    assert len(spy.calls) == 2
    for row in spy.calls:
        f, e = row["res"], row["generic"]
        b, x0, kw = row["args"]
        g = generic(row["system"])
        inv = row["system"].inv_mult

        def dot(a, c):
            return torch.dot((a * inv).flatten(), c.flatten())

        e2 = CG.pcg(b=b, x0=x0, **{**g, "dot": dot}, **kw)

        def true_residual(x):
            r = (b - g["A0"](x)).double()
            return float((r * r * inv).sum().sqrt())

        assert rel(f.x, e.x) <= max(tol, 3 * rel(e2.x, e.x))
        assert true_residual(f.x) <= 1.5 * max(true_residual(e.x),
                                               true_residual(e2.x))
        assert abs(int(f.iters) - int(e.iters)) <= 0.03 * int(e.iters)
        for again in row["more"]:        # deterministic run to run
            assert same(again, f)


def kernel_counts(fn):
    """Kernel records of one call of fn by name, from a profiler window
    padded with filler kernels at both ends (the profiler on the card
    drops a few records at a window's ends)."""
    buf = torch.zeros(256, dtype=torch.int16, device="cuda")
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(256):
            buf.fill_(1)
        fn()
        for _ in range(256):
            buf.fill_(1)
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        m = re.search(r"::(pap|xr|rz|p)_kernel<", e.name)
        if m and e.device_type == torch.autograd.DeviceType.CUDA:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


@pytest.mark.card
@pytest.mark.parametrize("pc,per_apply", [("jacobi", 3), ("fdm", 4)])
def test_card_epilogue_launches_per_application(card, pc, per_apply):
    p = problem(3, 24, 4, device=card, dtype=torch.float32, cg_rtol=1e-6,
                cg_maxiter=1000, pc=pc)
    vort, vel = state(p)
    stats = []
    LE.rhs_local(p.engine_ops, 0.0, vort, vel)       # warm
    counts = kernel_counts(
        lambda: LE.rhs_local(p.engine_ops, 0.0, vort, vel, stats=stats))
    applies = sum(n for _, n in stats)
    assert applies > 0
    assert sum(counts.values()) == per_apply * applies, (counts, applies)
    assert counts["pap"] == counts["xr"] == counts["p"] == applies
