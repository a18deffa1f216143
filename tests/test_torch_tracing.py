"""The port's in-program spans (utils/profiling.py): off, they are one
shared no-op and record nothing; on, they leave every field bitwise as it
was, nest as the layers do (rhs.eval > rhs.bc / kle.solve > pcg.*), count
what the CG loop does, and carry the solve's counts as attrs. On a tiny
2D no-slip cavity (two KLE stages per rhs), float64 on the CPU."""
import pytest
import torch

from pynama_tpu_torch.cases import Problem
from pynama_tpu_torch.utils import profiling
from pynama_tpu_torch.utils.profiling import span, tracing

torch.set_num_threads(1)

PHASES = ["mesh", "bc", "operators", "kle_solver", "engine",
          "initial_conditions"]


def _cavity():
    return {"name": "cavity",
            "material-properties": {"rho": 1.0, "mu": 0.02},
            "domain": {"ngl": 3, "box-mesh": {
                "nelem": [3, 3], "lower": [0, 0], "upper": [1, 1]}},
            "time-solver": {"start-time": 0, "end-time": 0.01,
                            "max-steps": 20},
            "boundary-conditions": {"no-slip": {
                "up": [1.0, 0.0], "down": [0, 0], "left": [0, 0],
                "right": [0, 0]}},
            "initial-conditions": {"vorticity": [0]}}


def _problem(solver):
    p = Problem(_cavity(), device="cpu", dtype=torch.float64, solver=solver,
                cg_rtol=1e-10, cg_maxiter=500)
    p.setUp()
    return p


def _state(p):
    """A random start state, the same on every call."""
    g = torch.Generator().manual_seed(7)
    n = p.mesh.n_nodes
    vort = torch.rand((n, 1), generator=g, dtype=torch.float64) - 0.5
    vel = torch.rand((n, 2), generator=g, dtype=torch.float64) - 0.5
    return vort, vel


def _rhs(p, vort, vel):
    """One rhs on the problem's own route: the engine's rhs_local (local
    layout) or Problem.rhs (global)."""
    if p.engine_ops is not None:
        from pynama_tpu_torch.engine.local_engine import rhs_local
        f, v = rhs_local(p.engine_ops, 0.0, p.to_local(vort),
                         p.to_local(vel), stats=p.cg_log)
        return f, v
    return p.rhs(0.0, vort, vel)


@pytest.fixture
def trace():
    """A fresh trace, stopped whatever the test does."""
    assert profiling._ACTIVE is None
    tr = tracing()
    try:
        yield tr
    finally:
        tr.stop()


def _children(recs, i):
    return [r for r in recs if r.parent == i]


def test_off_is_one_shared_noop():
    assert profiling._ACTIVE is None
    a, b = span("pcg.apply"), span("kle.solve")
    assert a is b
    with a as s:
        assert s is a
        s.attrs["iters"] = 3
    assert dict(a.attrs) == {}
    p = _problem("cg")
    _rhs(p, *_state(p))
    assert profiling._ACTIVE is None
    tr = tracing()
    tr.stop()
    _rhs(p, *_state(p))            # stopped: nothing more is recorded
    assert tr.names == [] and tr.records() == []


@pytest.mark.parametrize("solver", ["cg", "direct"])
def test_fields_bitwise_equal_on_and_off(solver):
    p = _problem(solver)
    vort, vel = _state(p)
    off = _rhs(p, vort, vel)
    tr = tracing()
    try:
        on = _rhs(p, vort, vel)
    finally:
        tr.stop()
    assert tr.names
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_trace_records_nest_and_keep_device_attrs(trace):
    x = torch.ones(3)
    with span("outer") as o:
        assert o.annotation is None      # no profiler: no record_function
        o.attrs["n"] = x.sum()           # a tensor, kept as it is
        with span("inner"):
            pass
        with span("inner"):
            pass
    recs = trace.records()
    assert [r.name for r in recs] == ["outer", "inner", "inner"]
    assert [r.parent for r in recs] == [-1, 0, 0]
    assert all(r.t0 <= r.t1 for r in recs)
    assert recs[0].t0 <= recs[1].t0 and recs[2].t1 <= recs[0].t1
    assert isinstance(recs[0].attrs["n"], torch.Tensor)
    assert dict(recs[1].attrs) == {}
    # the window filter keeps the spans lying inside it
    assert [r.name for r in trace.records(recs[1].t0, recs[2].t1)] \
        == ["inner", "inner"]
    assert tracing() is trace           # one trace while it is active


def test_engine_route_nesting_and_counts(trace):
    p = _problem("cg")
    p.cg_log = []
    _rhs(p, *_state(p))
    _rhs(p, *_state(p))
    recs = trace.records()
    evals = [i for i, r in enumerate(recs) if r.name == "rhs.eval"]
    assert len(evals) == 2 and all(recs[i].parent == -1 for i in evals)
    solves = []
    for i in evals:
        kids = _children(recs, i)
        assert [r.name for r in kids] \
            == ["rhs.bc", "rhs.bc", "kle.solve", "rhs.bc", "kle.solve"]
        solves += [j for j, r in enumerate(recs)
                   if r.parent == i and r.name == "kle.solve"]
    assert [recs[j].attrs["stage"] for j in solves] == ["fs", "main"] * 2
    assert len(p.cg_log) == len(solves) == 4
    check_every = 8
    for j, (iters, applies) in zip(solves, p.cg_log):
        a = recs[j].attrs
        assert a["method"] == "cg"
        assert isinstance(a["iters"], torch.Tensor)
        assert a["iters"] is iters and a["loop_applies"] == applies
        assert 0 < int(iters) <= applies
        kids = [r.name for r in _children(recs, j)]
        assert set(kids) == {"pcg.apply", "pcg.precond", "pcg.update",
                             "pcg.check"}
        assert kids.count("pcg.apply") == applies + 1
        assert kids.count("pcg.precond") == applies + 1
        # converged: a read at every check_every-th iteration, the last
        # one finding the loop done
        assert kids.count("pcg.check") == applies // check_every + 1
        assert kids[0] == "pcg.apply" and kids[-1] == "pcg.update"


def test_direct_route_spans(trace):
    p = _problem("direct")
    assert p.solver_method == "direct" and p.engine_ops is None
    _rhs(p, *_state(p))
    recs = trace.records()
    assert [r.name for r in recs if r.parent == -1] == ["rhs.eval"]
    kids = _children(recs, 0)
    assert [r.name for r in kids] \
        == ["rhs.bc", "rhs.bc", "kle.solve", "rhs.bc", "kle.solve"]
    solves = [j for j, r in enumerate(recs) if r.name == "kle.solve"]
    assert [dict(recs[j].attrs) for j in solves] == [
        {"method": "direct", "stage": "fs"},
        {"method": "direct", "stage": "main"}]
    assert not any(r.name.startswith("pcg.") for r in recs)
    assert all(not _children(recs, j) for j in solves)


def test_gmres_solve_span(trace):
    p = Problem(_cavity(), device="cpu", dtype=torch.float64,
                solver="gmres", cg_rtol=1e-10, cg_maxiter=500)
    p.setUp()
    p.cg_log = []
    _rhs(p, *_state(p))
    solves = [r for r in trace.records() if r.name == "kle.solve"]
    assert [(r.attrs["method"], r.attrs["stage"]) for r in solves] \
        == [("gmres", "fs"), ("gmres", "main")]
    assert [(r.attrs["iters"], r.attrs["loop_applies"]) for r in solves] \
        == p.cg_log


@pytest.mark.parametrize("solver", ["cg", "direct"])
def test_setup_phases_keep_their_keys(solver):
    p = _problem(solver)
    assert list(p.setup_phases) == PHASES
    assert all(v >= 0 for v in p.setup_phases.values())


def test_pcg_keeps_no_vector_past_its_use():
    """The spans split `r = b - A0(x0)` in two; A0(x0) is still freed
    before the loop's first application, as in one expression (on a card
    a vector more is more peak memory)."""
    import weakref
    from pynama_tpu_torch.solver.cg import pcg
    n = 64
    d = torch.linspace(1.0, 2.0, n, dtype=torch.float64)
    first = []
    seen = []

    def A0(v):
        y = d * v
        first.append(weakref.ref(y))
        return y

    def A(v):
        seen.append(first[0]() is None)
        return d * v

    pcg(A, torch.ones(n, dtype=torch.float64),
        torch.zeros(n, dtype=torch.float64), A0=A0, rtol=1e-12)
    assert seen and all(seen)
