"""The five metrics of the IBM loop (ibm.*): each reader on a synthetic
program trace, harness window and device trace, nothing read where the
program has no such span or no tracer, the cell's pieces loaded through
`load_cell` from the repository's BENCHMARK.json, and a CPU rehearsal of
a traced run of the ibm.dynamic cell cut to 8^2 elements, where the three
host-clock readers read and the two device readers read nothing (no
profiled replay without a card)."""
import dataclasses
import json
import sys
import time
import types

import pytest
import torch

from bench_paths import BENCH
from harness.cell import run_cell
from harness.spans import Span
from harness.spec import load_cell, load_named
from pynama_tpu_torch.utils import profiling

IBM = ("ibm.correct_ms", "ibm.cg_iters", "ibm.cg_iter_us",
       "ibm.cg_kernels_per_iter", "ibm.tables_us")
HOST = ("ibm.correct_ms", "ibm.cg_iters", "ibm.cg_iter_us")


def reader(name):
    return load_named("metrics", name)


def _trace(rows):
    """A program trace from (name, t0_s, t1_s, parent, attrs) rows."""
    tr = profiling.Trace()
    for name, a, b, parent, attrs in rows:
        if attrs:
            tr.attrs[len(tr.names)] = attrs
        tr.names.append(name)
        tr.t0.append(round(a * 1e9))
        tr.t1.append(round(b * 1e9))
        tr.parent.append(parent)
    return tr


def _cg(iters, applies):
    return {"iters": torch.tensor(iters), "loop_applies": applies}


TABLES = {"L": 79, "K": 25}
# the window's replays span [1, 9] s; the profiled replay [10, 11] s
ROWS = [
    ("ibm.correct", 0.2, 0.8, -1, None),     # set-up's warm: not read
    ("ibm.cg", 0.3, 0.7, 0, _cg(500, 504)),
    ("ibm.correct", 1.0, 1.1, -1, None),
    ("ibm.tables", 1.0, 1.001, 2, TABLES),
    ("ibm.cg", 1.001, 1.05, 2, _cg(130, 136)),
    ("rhs.eval", 2.0, 3.0, -1, None),
    ("ibm.correct", 3.0, 3.1, -1, None),
    ("ibm.tables", 3.0, 3.002, 6, TABLES),
    ("ibm.cg", 3.002, 3.032, 6, _cg(110, 112)),
    ("rhs.eval", 10.0, 10.5, -1, None),      # the profiled replay
    ("ibm.correct", 10.5, 10.6, -1, None),
    ("ibm.tables", 10.5, 10.51, 10, TABLES),
    ("ibm.cg", 10.51, 10.55, 10, _cg(100, 104)),
]


class Device:
    """The device records of a profiled window, by launching span."""

    def __init__(self, recs):
        self.records = [types.SimpleNamespace(span=s, dur=d)
                        for s, d in recs]

    def device_s(self, names=None, span=None):
        return 1e-6 * sum(r.dur for r in self.records
                          if span is None or r.span == span)


def _rec(trace, device, window=True):
    spans = [Span("stepper", 0.9, 5.0), Span("stepper", 5.0, 9.0)]
    if window:
        spans += [Span("correction", 1.0, 1.1), Span("correction", 3.0,
                                                     3.14)]
    return types.SimpleNamespace(
        spans=spans, profiled=[Span("rhs", 9.9, 11.1, profiled=True)],
        prepared={n: trace for n in IBM}, steps=2, trace=device)


DEVICE = [("ibm.cg", 2.0)] * 2080 + [("ibm.tables", 9.0)] * 12 \
    + [("correction", 3.0)] * 4 + [("rhs", 5.0)] * 3


def test_readers_on_a_synthetic_trace():
    rec = _rec(_trace(ROWS), Device(DEVICE))
    assert reader("ibm.correct_ms").read(rec) == pytest.approx(
        1e3 * (0.1 + 0.14) / 2)
    assert reader("ibm.cg_iters").read(rec) == pytest.approx(120.0)
    assert reader("ibm.cg_iter_us").read(rec) == pytest.approx(
        1e6 * (0.049 + 0.03) / (136 + 112))
    assert reader("ibm.cg_kernels_per_iter").read(rec) == \
        pytest.approx(2080 / 104)
    assert reader("ibm.tables_us").read(rec) == pytest.approx(12 * 9.0)


def test_readers_read_nothing_without_the_spans():
    """A program without the ibm.* spans, or no tracer at all, and no
    harness `correction` span: every reader returns None; without a
    profiled replay (no card) the two device readers do, the three
    host-clock ones still read."""
    bare = _trace([r for r in ROWS if r[0] == "rhs.eval"])
    for rec in (_rec(bare, Device(DEVICE), window=False),
                _rec(None, None, window=False)):
        for name in IBM:
            assert reader(name).read(rec) is None, name
    rec = _rec(_trace(ROWS), None)
    for name in IBM:
        assert (reader(name).read(rec) is None) != (name in HOST), name


def test_a_program_without_a_tracer(monkeypatch):
    fake = types.ModuleType("pynama_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "pynama_tpu_torch.utils.profiling",
                        fake)
    rec = types.SimpleNamespace(spans=[Span("stepper", 0.0, 1.0)],
                                profiled=[], trace=None, steps=1,
                                prepared={})
    for name in IBM:
        mod = reader(name)
        if hasattr(mod, "prepare"):
            rec.prepared[name] = mod.prepare(None, None)
            assert rec.prepared[name] is None
        assert mod.read(rec) is None


def test_the_cell_loads_from_the_spec():
    cell = load_cell("ibm.dynamic")
    assert cell.chips == 1 and cell.config["name"] == "ibm-dynamic-100-ngl3"
    assert cell.config["reduced"] == [] and cell.case["bodies"][0]["vel"] \
        == "dynamic"
    assert cell.mix["segment_steps"] == 10 and cell.mix["solver"] == "cg"
    assert set(cell.limits) == {"vort_rel", "vel_rel"}
    assert [m["name"] for m in cell.per_layer] == list(IBM)
    assert {m["name"] for m in cell.end_to_end} == {"step_s", "peak_mem_gb",
                                                    "setup_s"}
    for kind in ("program", "reference", "start"):
        assert cell.piece(kind) is not None
    spans = cell.metric("ibm.correct_ms").SPANS["correction"]["targets"]
    assert spans == [("pynama_tpu_torch.cases.ibm",
                      "ImmersedBoundaryDynamic._per_step_correction")]


@pytest.fixture
def no_trace_left():
    yield
    if profiling._ACTIVE is not None:
        profiling._ACTIVE.stop()


def test_traced_rehearsal_of_the_cell(tmp_path, no_trace_left):
    cell = load_cell("ibm.dynamic")
    cfg = json.loads(json.dumps(cell.config))
    cfg["case"]["domain"]["box-mesh"]["nelem"] = [8, 8]
    mix = dict(cell.mix, segment_steps=2)
    cell = dataclasses.replace(cell, config=cfg, mix=mix,
                               limits={"vort_rel": 1e-2, "vel_rel": 1e-2})
    r = run_cell(cell, 2**31 + 5, 0.5, True, t_start=time.perf_counter(),
                 device="cpu", out_dir=str(tmp_path), log=lambda m: None)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == set(HOST)
    assert m["ibm.correct_ms"] > 0 and m["ibm.cg_iter_us"] > 0
    assert m["ibm.cg_iters"] > 1
