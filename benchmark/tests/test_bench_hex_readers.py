"""The six metrics of the gmsh route (apply_k.*, dss.gather_us,
bc.func_ms): each reader on a synthetic program trace and device trace,
nothing read where the program has no such span or no tracer, and a CPU
rehearsal of a traced run of the tg3d.gmsh cell cut to 2^3 hexes, where
the two host-clock readers read the program's spans and the four device
readers read nothing (no profiled replay without a card)."""
import dataclasses
import json
import os
import sys
import time
import types

import pytest

from bench_paths import BENCH, ROOT
from harness.cell import run_cell
from harness.spans import Span
from harness.spec import load_cell, load_named
import counts
import counts_hex
from pynama_tpu_torch.utils import profiling

HEX = ("apply_k.element_us", "apply_k.kernels_per_call",
       "apply_k.enqueue_us", "apply_k.roofline", "dss.gather_us",
       "bc.func_ms")
K = {"route": "sumfact", "E": 15625, "ngl": 3}


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


# the window's replays span [1, 9] s; the profiled replay [10, 11] s
ROWS = [
    ("rhs.eval", 0.2, 0.8, -1, None),        # set-up's warm rhs: not read
    ("bc.func", 0.21, 0.5, 0, {"sides": 6}),
    ("rhs.eval", 1.0, 2.0, -1, None),
    ("rhs.bc", 1.0, 1.004, 2, None),
    ("bc.func", 1.0, 1.003, 3, {"sides": 6}),
    ("apply_k.element", 1.1, 1.1001, 2, K),
    ("dss.gather", 1.1001, 1.1002, 2, {"ncomp": 3}),
    ("apply_k.element", 1.2, 1.2003, 2, K),
    ("rhs.eval", 3.0, 4.0, -1, None),
    ("bc.func", 3.0, 3.001, 8, {"sides": 6}),
    ("rhs.eval", 10.0, 11.0, -1, None),      # the profiled replay
    ("apply_k.element", 10.1, 10.2, 10, K),
    ("dss.gather", 10.2, 10.3, 10, {"ncomp": 3}),
    ("apply_k.element", 10.3, 10.4, 10, K),
    ("dss.gather", 10.4, 10.5, 10, {"ncomp": 6}),
]


class Device:
    """The device records of a profiled window, by launching span."""

    def __init__(self, recs):
        self.records = [types.SimpleNamespace(span=s, dur=d)
                        for s, d in recs]

    def device_s(self, names=None, span=None):
        return 1e-6 * sum(r.dur for r in self.records
                          if span is None or r.span == span)


def _rec(trace, device):
    prepared = {n: trace for n in HEX}
    prepared["apply_k.roofline"] = None if trace is None else {
        "trace": trace, "dtype": "float32", "dim": 3}
    return types.SimpleNamespace(
        spans=[Span("stepper", 0.9, 5.0), Span("stepper", 5.0, 9.0)],
        profiled=[Span("rhs", 9.9, 11.1, profiled=True)],
        prepared=prepared, steps=2, trace=device)


DEVICE = [("apply_k.element", 40.0)] * 87 * 2 + [("dss.gather", 10.0)] * 10 \
    + [("rhs.eval", 5.0)] * 3


def test_readers_on_a_synthetic_trace():
    rec = _rec(_trace(ROWS), Device(DEVICE))
    assert reader("apply_k.element_us").read(rec) == pytest.approx(
        87 * 40.0)
    assert reader("apply_k.kernels_per_call").read(rec) == 87
    assert reader("apply_k.enqueue_us").read(rec) == pytest.approx(
        1e6 * 0.0004 / 2)
    bound = counts_hex.apply_k_bound_s(15625, 3, 3, "float32")
    assert reader("apply_k.roofline").read(rec) == pytest.approx(
        100.0 * 2 * bound / (2 * 87 * 40e-6))
    assert reader("dss.gather_us").read(rec) == pytest.approx(50.0)
    # two window rhs evaluations, 4 ms of bc.func between them
    assert reader("bc.func_ms").read(rec) == pytest.approx(1e3 * 0.004 / 2)


def test_readers_read_nothing_without_the_spans():
    """A box-mesh program (none of the three spans) or no tracer at all:
    every reader returns None; without a profiled replay (no card) the
    four device readers do, the two host-clock ones still read."""
    box = _trace([r for r in ROWS if r[0] in ("rhs.eval", "rhs.bc")])
    for rec in (_rec(box, Device(DEVICE)), _rec(None, None)):
        for name in HEX:
            assert reader(name).read(rec) is None, name
    rec = _rec(_trace(ROWS), None)
    for name in HEX:
        host = name in ("apply_k.enqueue_us", "bc.func_ms")
        assert (reader(name).read(rec) is None) != host, name


def test_a_program_without_a_tracer(monkeypatch):
    fake = types.ModuleType("pynama_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "pynama_tpu_torch.utils.profiling",
                        fake)
    program = types.SimpleNamespace(problem=types.SimpleNamespace(dim=3))
    rec = types.SimpleNamespace(spans=[Span("stepper", 0.0, 1.0)],
                                profiled=[], trace=None, steps=1,
                                prepared={})
    for name in HEX:
        mod = reader(name)
        rec.prepared[name] = mod.prepare(program, None)
        assert rec.prepared[name] is None
        assert mod.read(rec) is None


def test_counts_hex_matches_the_chip_smoke_count():
    """The 10^3 ngl=4 hex apply of chip_smoke phase 14 (a): 3.2 us, bound
    by operations; the cell's 25^3 ngl=3 one: 9.05 us, bound by bytes."""
    for shape, us, by in (((1000, 4), 3.2244, "operations"),
                          ((15625, 3), 9.0523, "bytes")):
        cost = counts_hex.apply_k_cost(*shape, 3, "float32")
        assert counts.bound_s(*cost, "float32")[1] == by
        assert 1e6 * counts_hex.apply_k_bound_s(*shape, 3, "float32") \
            == pytest.approx(us, rel=1e-4)


@pytest.fixture
def no_trace_left():
    yield
    if profiling._ACTIVE is not None:
        profiling._ACTIVE.stop()


def test_traced_rehearsal_of_the_cell(tmp_path, no_trace_left):
    cell = load_cell("tg3d.gmsh")
    cfg = json.loads(json.dumps(cell.config))
    cfg["case"]["domain"]["hex-cube"]["nelem"] = [2, 2, 2]
    cell = dataclasses.replace(cell, config=cfg,
                               limits={"vort_rel": 1e-3, "vel_rel": 1e-2})
    assert [m["name"] for m in cell.per_layer] == list(HEX)
    r = run_cell(cell, 2**31 + 5, 0.5, True, t_start=time.perf_counter(),
                 device="cpu", out_dir=str(tmp_path), log=lambda m: None)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == {"apply_k.enqueue_us", "bc.func_ms"}
    assert m["apply_k.enqueue_us"] > 0 and m["bc.func_ms"] > 0
