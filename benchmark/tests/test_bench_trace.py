"""The trace reader and the metric arithmetic on synthetic spans and
device records: span self time, the union of kernel intervals, the idle
share, the attribution of a kernel to the span that launched it, and the
roofline ratio."""
import json
import types

import pytest

import bench_paths  # noqa: F401 (puts the benchmark on sys.path)
from harness.spans import Span, Spans, layer_spans, merge
from harness.spec import load_named
from harness.trace import Window, read_trace

FILL = "fill_kernel"


def metric_reader(name):
    return load_named("metrics", name).read


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return read_trace(str(path), {FILL}, {"rhs", "cg", "fdm"})


def test_window_union_idle_and_attribution(tmp_path):
    ev = [_ev("kernel", FILL, 0, 5), _ev("kernel", FILL, 5, 5),
          # work: [10, 20] and [15, 25] overlap, then a gap to [40, 50]
          _ev("kernel", "k1_gemm", 10, 10, 1), _ev("kernel", "axpy", 15, 10,
                                                   2),
          _ev("kernel", "fdm_bmm", 40, 10, 3),
          _ev("kernel", FILL, 60, 5), _ev("kernel", FILL, 70, 5),
          _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, 1),
          _ev("cuda_runtime", "cudaLaunchKernel", 4, 1, 2),
          _ev("cuda_runtime", "cudaLaunchKernel", 30, 1, 3),
          _ev("user_annotation", "rhs", 1, 40),
          _ev("user_annotation", "cg", 3, 30),
          _ev("user_annotation", "fdm", 29, 3),
          _ev("user_annotation", "other", 0, 100)]
    w = _trace(tmp_path, ev)
    assert [r.name for r in w.records] == ["k1_gemm", "axpy", "fdm_bmm"]
    assert [r.span for r in w.records] == ["rhs", "cg", "fdm"]
    assert w.window_s == pytest.approx(50e-6)      # [10, 60]
    assert w.busy_s == pytest.approx(25e-6)        # [10, 25] + [40, 50]
    assert sum(s for _, s in w.gaps) == pytest.approx(25e-6)
    assert w.device_s(span="fdm") == pytest.approx(10e-6)
    assert w.device_s(names={"k1_gemm"}) == pytest.approx(10e-6)
    assert w.top_gaps()[0] == ["fdm: fdm_bmm", pytest.approx(15e-6)]
    rec = types.SimpleNamespace(trace=w)
    assert metric_reader("device.idle_share")(rec) == pytest.approx(50.0)


def test_roofline_and_fdm_readers():
    """The roofline counts the work from the applications the profiled
    range made: at 24^3 ngl=4 f32 one two-stage rhs is 8 applications at
    192->192 (15.2 us each), one at 192->384 and one at 384->192 (30.4
    us), and each CG loop application one more at 192->192."""
    w = Window([], 1.0, 0.5, [])
    w.records = [types.SimpleNamespace(name="g", dur=400.0, span="cg"),
                 types.SimpleNamespace(name="d", dur=246.0, span="cg"),
                 types.SimpleNamespace(name="x", dur=30.0, span="fdm")]
    profiled = [Span("rhs", 0.0, 1.0, profiled=True),
                Span("cg", 0.1, 0.5, parent=0, profiled=True,
                     info={"loop_applies": 5, "iters": 5})] \
        + [Span("fdm", 0.2, 0.3, parent=1, profiled=True)] * 3
    k1 = {"names": {"g", "d"}, "nelem": (24, 24, 24), "ngl": 4, "dim": 3,
          "two_stage": True, "dtype": "float32"}
    rec = types.SimpleNamespace(trace=w, profiled=profiled,
                                prepared={"k1_roofline": k1})
    bound_us = 8 * 15.2 + 2 * 30.4 + 5 * 15.2
    assert metric_reader("k1_roofline")(rec) == pytest.approx(
        100 * bound_us / 646.0, rel=5e-3)
    assert metric_reader("fdm.apply_us")(rec) == pytest.approx(10.0)
    rec.prepared = {"k1_roofline": None}
    assert metric_reader("k1_roofline")(rec) is None   # nothing to read
    rec.profiled = []
    assert metric_reader("fdm.apply_us")(rec) is None


def test_span_metrics():
    s = [Span("stepper", 0.0, 10.0),
         Span("rhs", 0.0, 1.0, parent=0), Span("cg", 0.1, 0.4, parent=1,
                                               info={"loop_applies": 300,
                                                     "iters": 250}),
         Span("cg", 0.4, 0.9, parent=1, info={"loop_applies": 200,
                                               "iters": 150}),
         Span("rhs", 1.0, 1.5, parent=0), Span("direct", 1.1, 1.3, parent=4)]
    rec = types.SimpleNamespace(spans=s, steps=1, prepared={})
    assert metric_reader("rhs.self_ms")(rec) == pytest.approx(
        1e3 * (0.2 + 0.3) / 2)
    assert metric_reader("cg.iter_us")(rec) == pytest.approx(1e6 * 0.8 / 500)
    assert metric_reader("direct.solve_us")(rec) == pytest.approx(2e5)
    assert metric_reader("stepper.rhs_per_step")(rec) == 2
    assert metric_reader("cg.iters_per_solve")(rec) == 200
    assert metric_reader("setup.assemble_s")(rec) is None


def test_spans_are_declared_by_the_modules_that_read_them():
    """The cell's span declarations merge (targets and info united, a span
    kept out of the window when any module says so), and the wrappers go
    where the declarations say, conditions included, and come off."""
    import sys
    import types as T
    mod = T.ModuleType("bench_fake_layer")

    class Result:
        loop_applies, iters = 7, 3

    class Sys:
        def __init__(self, method):
            self.method = method

    mod.solve = lambda a, b, sys_: Result()
    mod.fdm = lambda x: x
    sys.modules["bench_fake_layer"] = mod
    try:
        d = merge([
            {"cg": {"targets": [("bench_fake_layer", "solve")],
                    "info": ("loop_applies",)}},
            {"cg": {"targets": [["bench_fake_layer", "solve"]],
                    "info": ("iters",)},
             "direct": {"targets": [("bench_fake_layer", "solve",
                                     (2, "method", "direct"))]},
             "fdm": {"targets": [("bench_fake_layer", "fdm")],
                     "window": False}}])
        assert d["cg"]["targets"] == [("bench_fake_layer", "solve")]
        assert d["cg"]["info"] == ("loop_applies", "iters")
        assert not d["fdm"]["window"] and d["direct"]["window"]
        orig = mod.solve
        sp = Spans(sync=False)
        with layer_spans(sp, d):
            mod.solve(0, 0, Sys("cg"))
            mod.solve(0, 0, Sys("direct"))
            mod.fdm(1)
        assert mod.solve is orig
        # a callable two spans wrap: the later one (by name) outside
        assert [s.name for s in sp.records] == ["cg", "direct", "cg"]
        assert sp.records[2].parent == 1
        assert sp.records[0].info == {"loop_applies": 7, "iters": 3}
        sp = Spans(sync=False)
        with layer_spans(sp, d, profiled=True):
            mod.fdm(1)
        assert [s.name for s in sp.records] == ["fdm"]
    finally:
        del sys.modules["bench_fake_layer"]
