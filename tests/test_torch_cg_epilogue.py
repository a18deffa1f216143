"""The fused CG epilogue (ops/cg_epilogue.py, csrc/cg_epilogue.cu) and where
pcg takes it.

On the CPU the epilogue's plain versions run the step functions pcg's
eager loop is written in, so a fused solve gives bitwise the eager loop's
x, iters, residual and loop_applies: on 2D and 3D box meshes under every preconditioner, on a
dense system stopped early inside a check block, at the maxiter cap and
with b == 0. The engine takes the epilogue on an unsharded engine only;
the sharded engine, the global layout (solver/kle.py) and the IBM
correction CGs keep the eager loop. `cg.fused_share` reads the engine's
`kle.solve` attribute.

Tests marked `card` compare the kernels with their plain versions and the
fused loop with the eager one on an NVIDIA card, and skip without one. The
file imports no JAX; on the card run them without the JAX-loading
conftest: `python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_cg_epilogue.py`.
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


class Spy:
    """Stands in for local_engine's pcg: runs the solve as the engine asked
    (fused where it passed an epilogue) and, where it did, again on the
    eager loop (and `again` more times fused); keeps every result."""

    def __init__(self, again=0):
        self.calls, self.again = [], again

    def __call__(self, *args, **kw):
        res = CG.pcg(*args, **kw)
        ep = kw.get("epilogue")
        row = {"epilogue": ep, "res": res, "more": [], "args": (args, kw)}
        if ep is not None:
            row["eager"] = CG.pcg(*args, **{**kw, "epilogue": None})
            row["more"] = [CG.pcg(*args, **kw) for _ in range(self.again)]
        self.calls.append(row)
        return res


def same(a: CG.CGResult, b: CG.CGResult) -> bool:
    return (torch.equal(a.x, b.x) and torch.equal(a.iters, b.iters)
            and a.iters.dtype == b.iters.dtype
            and torch.equal(a.residual, b.residual)
            and a.loop_applies == b.loop_applies)


# ------------------------------------------------- CPU: bitwise the eager
@pytest.mark.parametrize("pc", ["jacobi", "fdm", "schwarz"])
@pytest.mark.parametrize("dim,nelem", [(2, 3), (3, 2)])
def test_engine_solves_bitwise_eager(dim, nelem, pc, monkeypatch):
    """Both KLE stages of one rhs: the fused plain-version loop gives the
    eager loop's fields bit for bit."""
    p = problem(dim, nelem, 3, pc=pc)
    spy = Spy()
    monkeypatch.setattr(LE, "pcg", spy)
    LE.rhs_local(p.engine_ops, 0.0, *state(p))
    assert len(spy.calls) == 2
    for row in spy.calls:
        ep = row["epilogue"]
        assert isinstance(ep, E.Epilogue)
        assert (ep.dmask is not None) == (pc == "jacobi")
        M_inv = row["args"][1]["M_inv"]        # Precond's loop form
        assert not isinstance(M_inv, LE.Precond) and callable(M_inv)
        assert same(row["res"], row["eager"])
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


def dense_system(n=60, n_con=7, seed=3):
    """A masked SPD system as the engine builds one, on flat vectors: (A,
    A0, b, x0, M_inv, dot, dots, Epilogue)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    K = torch.tensor((Q * np.geomspace(1.0, 1e4, n)) @ Q.T)
    free = torch.ones(n, dtype=torch.float64)
    free[torch.tensor(rng.choice(n, size=n_con, replace=False))] = 0.0
    con = 1.0 - free
    vel = torch.tensor(rng.standard_normal(n))
    rhs = torch.tensor(rng.standard_normal(n))
    inv = torch.full((n,), 0.5, dtype=torch.float64)   # keeps A symmetric
    vc = con * vel
    b = free * (rhs - K @ vc) + vc
    dmask = free * torch.diagonal(K) + con

    def M_inv(r):
        return r / dmask

    def dot(a, c):
        return (a * c * inv).sum()

    ep = E.Epilogue(apply=lambda v: K @ v, free=free, inv_mult=inv,
                    dmask=dmask)
    return dict(A=lambda v: free * (K @ v),
                A0=lambda v: free * (K @ (free * v)) + con * v, b=b,
                x0=free * vel + vc, M_inv=M_inv, dot=dot,
                dots=lambda pairs: [dot(a, c) for a, c in pairs], ep=ep)


def solve_both(s, **kw):
    args = dict(M_inv=s["M_inv"], dot=s["dot"], A0=s["A0"], dots=s["dots"],
                **kw)
    eager = CG.pcg(s["A"], s["b"], s["x0"], **args)
    fused = CG.pcg(s["A"], s["b"], s["x0"], epilogue=s["ep"], **args)
    return fused, eager


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
    fused, eager = solve_both(s, rtol=rtol, maxiter=maxiter)
    assert same(fused, eager)
    assert torch.equal(s["x0"], x0)          # x0 is not written
    it, n = int(fused.iters), fused.loop_applies
    if want == "early":
        assert 0 < it < n and it % 8 != 0
    elif want == "cap":
        assert it == n == maxiter
    else:
        assert it == n == 0 and not fused.x.any()


def test_eager_preconditioner_route_bitwise():
    """With M_inv eager (no dmask) the loop takes cg_rz: still bitwise."""
    s = dense_system(seed=4)
    s["ep"] = s["ep"]._replace(dmask=None)
    fused, eager = solve_both(s, rtol=1e-10, maxiter=500)
    assert same(fused, eager) and int(fused.iters) > 0


def test_identity_preconditioner_keeps_r():
    """M_inv = identity makes the prologue's p and r one tensor; the
    state copies p, so the in-place updates keep them apart."""
    s = dense_system(seed=5)
    ident = lambda r: r
    s["M_inv"] = ident
    s["ep"] = s["ep"]._replace(dmask=None)
    fused, eager = solve_both(s, rtol=1e-10, maxiter=500)
    assert same(fused, eager)


# ------------------------------------------------------------ the wrappers
def cpu_state(n=40, dtype=torch.float64, dmask=True):
    g = torch.Generator().manual_seed(1)
    v = [torch.rand(n, generator=g, dtype=dtype) + 0.5 for _ in range(6)]
    ep = E.Epilogue(apply=None, free=v[0], inv_mult=v[1],
                    dmask=v[2] if dmask else None)
    s = lambda x: torch.tensor(x, dtype=dtype)
    st = E.CGState(ep, v[3], v[4], v[5], s(2.0), s(3.0), s(1e-8),
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
    vecs = dict(free=f(), inv_mult=f(), dmask=f())
    x0, r, z = f(), f(), f()
    if bad == "dtype":
        x0, r, z = f(torch.int64), f(torch.int64), f(torch.int64)
        vecs = {k: f(torch.int64) for k in vecs}
    elif bad == "mixed":
        vecs["dmask"] = f(torch.float32)
    elif bad == "shape":
        vecs["inv_mult"] = f(m=n + 1)
    else:
        x0, r, z = (torch.ones(n, dtype=torch.float64, device="meta")
                    for _ in range(3))
    s = torch.tensor(1.0, dtype=torch.float64)
    with pytest.raises(TypeError if bad in ("dtype", "mixed")
                       else ValueError):
        E.CGState(E.Epilogue(apply=None, **vecs), x0, r, z, s, s, s,
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


# --------------------------------------------------- where the engine takes it
def test_unsharded_engine_runs_fused():
    p = problem(2, 3, 3)
    tr = tracing()
    try:
        LE.rhs_local(p.engine_ops, 0.0, *state(p))
    finally:
        tr.stop()
    solves = [r for r in tr.records() if r.name == "kle.solve"]
    assert [r.attrs["epilogue"] for r in solves] == ["fused", "fused"]


class FakeComm:
    """Two ranks' collectives as one rank sees them when its neighbours
    send zeros: enough to drive the sharded route's branches."""
    size = 2

    def psum(self, x):
        return x

    def exchange(self, a, b):
        return torch.zeros_like(a), torch.zeros_like(b)


def test_sharded_engine_keeps_the_eager_loop(monkeypatch):
    p = problem(2, 3, 3)
    ops = dataclasses.replace(p.engine_ops, comm=FakeComm(), cg_maxiter=9)
    assert LE._sharded(ops)
    spy = Spy()
    monkeypatch.setattr(LE, "pcg", spy)
    tr = tracing()
    try:
        LE.rhs_local(ops, 0.0, *state(p))
    finally:
        tr.stop()
    assert len(spy.calls) == 2
    assert all(row["epilogue"] is None for row in spy.calls)
    assert [r.attrs["epilogue"] for r in tr.records()
            if r.name == "kle.solve"] == ["eager", "eager"]


def test_global_layout_keeps_the_eager_loop(monkeypatch):
    p = problem(2, 3, 3, engine=False)
    assert p.engine_ops is None
    seen = []

    def spy(*args, **kw):
        seen.append(kw.get("epilogue"))
        return CG.pcg(*args, **kw)

    import pynama_tpu_torch.solver.kle as KLE
    monkeypatch.setattr(KLE, "pcg", spy)
    tr = tracing()
    try:
        p.rhs(0.0, p.vort, p.vel)
    finally:
        tr.stop()
    assert seen == [None, None]
    assert [(r.attrs["method"], r.attrs["epilogue"]) for r in tr.records()
            if r.name == "kle.solve"] == [("cg", "eager")] * 2


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
    from pynama_tpu_torch.ibm import interpolation as TI
    from pynama_tpu_torch.ibm.sharded import (build_ibm_shard_tables,
                                              correction_cg_local)
    from pynama_tpu_torch.ops import local as TL
    from pynama_tpu_torch.parallel.comm import SlabComm
    seen = []

    def spy(*args, **kw):
        seen.append(kw.get("epilogue"))
        return pcg(*args, **kw)

    pcg = CG.pcg
    monkeypatch.setattr(CG, "pcg", spy)
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
    assert seen == [None, None] and int(it) > 0 and int(it_l) > 0


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
    """A CUDA CGState on random vectors (and its constants), run and live
    true, k = 3."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda: (torch.rand(n, generator=g, dtype=torch.float64)
                 + 0.5).to(dtype).to(dev)
    free = (torch.rand(n, generator=g) > 0.05).to(dtype).to(dev)
    ep = E.Epilogue(apply=None, free=free, inv_mult=r(),
                    dmask=r() if dmask else None)
    s = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    st = E.CGState(ep, r(), r(), r(), s(2.5), s(3.0), s(1e-30),
                   torch.tensor(True, device=dev),
                   torch.tensor(True, device=dev),
                   torch.tensor(3, device=dev), 1000)
    return st, r


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("jacobi", [True, False])
def test_card_kernels_match_plain(card, dtype, jacobi):
    """One iteration's steps at the flagship's vector length (24^3 ngl=4,
    2,654,208 values, and one value more, for the unpacked tail): vectors
    and scalars against the plain versions run on copies."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for n in (13824 * 192, 13824 * 192 + 1):
        st, r = random_state(card, dtype, n, jacobi)
        ref = {k: getattr(st, k).clone() for k in ("x", "r", "p", "sf", "si")}
        y, zin = r(), r()
        y_ref = y.clone()
        counts = {k: fn.launches for k, fn in STEPS.items()}
        ap = E.cg_pap(st, y)
        E.cg_xr(st, ap)
        ap_ref = E.cg_pap_ref(y_ref, ref["p"], st.free, st.inv, ref["sf"],
                              ref["si"])
        E.cg_xr_ref(ref["x"], ref["r"], ref["p"], ap_ref, st.inv, ref["sf"],
                    ref["si"], st.maxiter, st.dmask)
        if jacobi:
            E.cg_p(st)
            E.cg_p_ref(ref["p"], ref["r"] / st.dmask, ref["sf"])
        else:
            E.cg_rz(st, zin)
            E.cg_p(st, zin)
            E.cg_rz_ref(ref["r"], zin, st.inv, ref["sf"], ref["si"],
                        st.maxiter)
            E.cg_p_ref(ref["p"], zin, ref["sf"])
        torch.cuda.synchronize()
        want = {"cg_pap": 1, "cg_xr": 1, "cg_p": 1, "cg_rz": 0 if jacobi
                else 1}
        assert {k: fn.launches - counts[k] for k, fn in STEPS.items()} \
            == want
        assert rel(ap, ap_ref) <= tol
        for k in ("x", "r", "p"):
            assert rel(getattr(st, k), ref[k]) <= tol, k
        assert torch.allclose(st.sf.double(), ref["sf"].double(), rtol=tol,
                              atol=0), (st.sf, ref["sf"])
        assert torch.equal(st.si, ref["si"])
        assert st.si.tolist() == [4, 1, 1]


def flagship_spy(card, dtype, pc="jacobi", again=1):
    """One rhs of the 24^3 ngl=4 cavity (the flagship's mesh) on the card
    from a random state, every CG solve run fused (again more times) and
    eager."""
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
    within 3 % of the eager loop's; the fused iterate as close to the eager
    one as the eager loop comes to itself when its dot products are only
    summed in another order (rounding alone), or within 1e-5 (f32) / 1e-12
    (f64); its true residual no larger; and two fused runs bitwise equal."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    spy = flagship_spy(card, dtype)
    assert len(spy.calls) == 2
    for row in spy.calls:
        f, e = row["res"], row["eager"]
        args, kw = row["args"]
        inv = kw["epilogue"].inv_mult

        def dot(a, c):
            return torch.dot((a * inv).flatten(), c.flatten())

        e2 = CG.pcg(*args, **{**kw, "epilogue": None, "dot": dot,
                              "dots": lambda ps: [dot(a, c) for a, c in ps]})
        b, A0 = args[1], kw["A0"]

        def true_residual(x):
            r = (b - A0(x)).double()
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
