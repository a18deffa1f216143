"""The IBM loop's spans (cases/ibm.py, ibm/interpolation.py): with
tracing on, `ibm.correct` opens once per velocity correction (the one at
t0 and one after each accepted step; attrs L, moving), and for a moving
body each correction holds one `ibm.tables` (attrs L, K) and one `ibm.cg`
(attrs iters, the correction CG's device count, and loop_applies); a fixed
body opens neither of the two. With tracing off nothing records, tracing
leaves the fields bitwise as they were, and the harness's `cg` spans,
which patch the KLE solver's `pcg` names, never open around the
correction's CG. ibm-dynamic.yaml cut to 8^2 elements, float64 on the
CPU, two steps."""
import copy
import os
import sys

import pytest
import torch

from pynama_tpu_torch.cases import ibm as IBM
from pynama_tpu_torch.run_case import load_case, make_problem
from pynama_tpu_torch.utils import profiling
from pynama_tpu_torch.utils.profiling import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness.spans import Spans, layer_spans, merge  # noqa: E402
from harness.spec import load_named  # noqa: E402

torch.set_num_threads(1)

STEPS = 2


def problem(moving=True):
    cfg = copy.deepcopy(load_case("ibm-dynamic"))
    cfg["domain"]["box-mesh"]["nelem"] = [8, 8]
    cfg["time-solver"].update({"max-steps": STEPS, "end-time": 1.0})
    if not moving:
        cfg["bodies"][0].pop("vel")
    p = make_problem(cfg, device="cpu", dtype=torch.float64, solver="cg",
                     cg_rtol=1e-10, cg_maxiter=500)
    p.setUp()
    return p


@pytest.fixture(scope="module")
def moving():
    return problem()


def march(p):
    p.vort, p.vel = (torch.zeros_like(p.vort), torch.zeros_like(p.vel))
    t, steps = p.start_solver(dt0=3e-4)
    return t, steps, p.vort.clone(), p.vel.clone()


@pytest.fixture
def trace():
    tr = tracing()
    yield tr
    tr.stop()


def _by_name(tr):
    recs = tr.records()
    return recs, {n: [i for i, r in enumerate(recs) if r.name == n]
                  for n in ("ibm.correct", "ibm.tables", "ibm.cg")}


def test_moving_body_opens_its_spans(moving, trace):
    p = moving
    _, steps, _, _ = march(p)
    recs, by = _by_name(trace)
    assert steps == STEPS
    assert len(by["ibm.correct"]) == steps + 1 == len(p.corr_log)
    for i in by["ibm.correct"]:
        assert recs[i].attrs == {"L": p.body.n_nodes, "moving": True}
    assert len(by["ibm.tables"]) == len(by["ibm.cg"]) == steps + 1
    for i in by["ibm.tables"]:
        assert recs[i].attrs == {"L": p.body.n_nodes, "K": 25}
        assert recs[recs[i].parent].name == "ibm.correct"
    iters = []
    for i in by["ibm.cg"]:
        assert recs[recs[i].parent].name == "ibm.correct"
        a = recs[i].attrs
        assert a["loop_applies"] >= int(a["iters"]) > 0
        iters.append(int(a["iters"]))
    assert iters == [it for it, _ in p.corr_log]
    # the loop's own spans stay inside ibm.cg
    inner = {recs[r.parent].name for r in recs
             if r.name.startswith("pcg.") and r.parent >= 0
             and recs[r.parent].name.startswith("ibm.")}
    assert inner == {"ibm.cg"}


def test_fixed_body_opens_only_the_correction(trace):
    p = problem(moving=False)
    assert type(p) is IBM.ImmersedBoundaryStatic
    _, steps, _, _ = march(p)
    recs, by = _by_name(trace)
    assert len(by["ibm.correct"]) == steps + 1
    assert all(recs[i].attrs == {"L": p.body.n_nodes, "moving": False}
               for i in by["ibm.correct"])
    assert by["ibm.tables"] == by["ibm.cg"] == []


def test_tracing_off_records_nothing(moving, monkeypatch):
    assert profiling._ACTIVE is None
    opened = []
    monkeypatch.setattr(profiling.Trace, "open",
                        lambda self, name: opened.append(name))
    _, steps, vort, _ = march(moving)
    assert opened == [] and steps == STEPS and torch.isfinite(vort).all()


def test_spans_leave_the_fields_bitwise(moving):
    a = march(moving)
    tr = tracing()
    try:
        b = march(moving)
    finally:
        tr.stop()
    assert any(n == "ibm.cg" for n in tr.names)
    assert a[:2] == b[:2]
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


def test_harness_cg_spans_miss_the_correction(moving):
    """The `cg` declaration of the benchmark's CG metrics wraps the KLE
    solver's `pcg` names; the correction CG calls `solver.cg.pcg` and
    opens none of them, while each KLE solve does."""
    decls = merge([load_named("metrics", "cg.iter_us").SPANS])
    spans = Spans(sync=False)
    p = moving
    p._start_correction()
    vel = torch.zeros_like(p.vel)
    with layer_spans(spans, decls):
        p._per_step_correction(vel, 0.0)
        assert spans.records == []
        p.solve_kle(p.vort, vel)
    assert [s.name for s in spans.records] == ["cg"]
