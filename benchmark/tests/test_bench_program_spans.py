"""The metrics that read the program's own spans: each reader on a
synthetic trace, the label-only `SPANS` entries (no callable patched, the
name still labels device records), a CPU rehearsal of a traced run with
the readers in place, and an older program without a tracer, where they
read nothing and raise nothing."""
import dataclasses
import json
import os
import sys
import time
import types

import pytest

from bench_paths import FIXTURE
from harness.cell import run_cell
from harness.spans import Span, Spans, layer_spans, merge
from harness.spec import load_cell, load_named
from harness.trace import read_trace
from pynama_tpu_torch.utils import profiling

NEW = ("cg.enqueue_us", "cg.check_wait_us", "cg.kernels_per_apply",
       "bc.apply_ms", "setup.problem_s")


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


def _cg(applies):
    return {"method": "cg", "stage": "main", "loop_applies": applies,
            "iters": applies - 1}


# the window's replays span [1, 9] s; the profiled replay [10, 11] s
ROWS = [
    ("rhs.eval", 0.2, 0.8, -1, None),          # set-up's warm rhs: not read
    ("rhs.bc", 0.21, 0.22, 0, None),
    ("rhs.eval", 1.0, 2.0, -1, None),
    ("rhs.bc", 1.0, 1.001, 2, None),
    ("rhs.bc", 1.001, 1.003, 2, None),
    ("kle.solve", 1.1, 1.9, 2, _cg(10)),
    ("pcg.apply", 1.1, 1.2, 5, None),
    ("pcg.update", 1.2, 1.3, 5, None),
    ("pcg.precond", 1.3, 1.4, 5, None),
    ("pcg.check", 1.4, 1.6, 5, None),
    ("rhs.eval", 3.0, 4.0, -1, None),
    ("rhs.bc", 3.0, 3.003, 10, None),
    ("kle.solve", 3.1, 3.5, 10, {"method": "direct", "stage": "main"}),
    ("kle.solve", 3.5, 3.9, 10, _cg(30)),
    ("pcg.apply", 3.5, 3.7, 13, None),
    ("pcg.check", 3.7, 3.8, 13, None),
    ("rhs.eval", 10.0, 11.0, -1, None),        # the profiled replay
    ("kle.solve", 10.1, 10.9, 16, _cg(5)),
    ("pcg.apply", 10.1, 10.5, 17, None),
]


def _rec(trace, device=None):
    spans = [Span("stepper", 0.9, 5.0), Span("stepper", 5.0, 9.0)]
    profiled = [Span("rhs", 9.9, 11.1, profiled=True)]
    prepared = {n: trace for n in NEW if n != "setup.problem_s"}
    prepared["setup.problem_s"] = 4.25
    return types.SimpleNamespace(spans=spans, profiled=profiled,
                                 prepared=prepared, steps=2, trace=device)


def test_readers_on_a_synthetic_trace():
    tr = _trace(ROWS)
    device = types.SimpleNamespace(records=[
        types.SimpleNamespace(span=s) for s in
        ["pcg.apply"] * 6 + ["pcg.update"] * 3 + ["fdm"] * 2
        + ["kle.solve", "rhs.eval", "cg"]])
    rec = _rec(tr, device)
    issue = 0.1 + 0.1 + 0.1 + 0.2               # apply, update, precond
    assert reader("cg.enqueue_us").read(rec) == pytest.approx(
        1e6 * issue / 40)
    assert reader("cg.check_wait_us").read(rec) == pytest.approx(
        1e6 * 0.3 / 40)
    # profiled range: 11 records of pcg.* and fdm over 5 loop applications
    assert reader("cg.kernels_per_apply").read(rec) == pytest.approx(11 / 5)
    assert reader("bc.apply_ms").read(rec) == pytest.approx(
        1e3 * 0.006 / 2)
    assert reader("setup.problem_s").read(rec) == 4.25
    # nothing to read: no profiled trace, no CG solve, no trace at all
    rec.trace = None
    assert reader("cg.kernels_per_apply").read(rec) is None
    rec = _rec(_trace([r for r in ROWS if r[0] != "kle.solve"]), device)
    assert reader("cg.enqueue_us").read(rec) is None
    assert reader("cg.check_wait_us").read(rec) is None
    rec = _rec(None, device)
    rec.prepared["setup.problem_s"] = None
    for name in NEW:
        assert reader(name).read(rec) is None


def test_label_only_spans_patch_nothing_and_label(tmp_path):
    mod = types.ModuleType("bench_fake_solver")
    mod.pcg = lambda x: x
    sys.modules["bench_fake_solver"] = mod
    try:
        d = merge([reader("cg.enqueue_us").SPANS,
                   {"cg": {"targets": [("bench_fake_solver", "pcg")]}}])
        assert d["pcg.apply"] == {"targets": [], "info": (),
                                  "window": False}
        orig = mod.pcg
        for profiled in (False, True):
            sp = Spans(sync=False)
            with layer_spans(sp, d, profiled=profiled):
                mod.pcg(1)
            assert [s.name for s in sp.records] == ["cg"]
            assert mod.pcg is orig
    finally:
        del sys.modules["bench_fake_solver"]
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": 5,
           "args": {"correlation": c}}
          for n, ts, c in (("fill", 0, None), ("axpy", 20, 1),
                           ("k1", 40, 2), ("fill", 60, None))]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "args": {"correlation": c}}
           for ts, c in ((12, 1), (32, 2))]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts,
            "dur": dur} for n, ts, dur in (("cg", 10, 30),
                                           ("pcg.update", 11, 5),
                                           ("pcg.apply", 31, 5))]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    w = read_trace(str(path), {"fill"}, {"stepper", *d})
    assert [(r.name, r.span) for r in w.records] == [
        ("axpy", "pcg.update"), ("k1", "pcg.apply")]
    assert [g[0] for g in w.gaps][:2] == ["pcg.update: axpy",
                                          "pcg.apply: k1"]


def _cell(name):
    cell = load_cell(name, os.path.join(FIXTURE, "BENCHMARK.json"), FIXTURE)
    extra = [{"name": n, "unit": "-", "source": "program_span"}
             for n in NEW]
    return dataclasses.replace(cell, per_layer=cell.per_layer + extra)


@pytest.fixture
def no_trace_left():
    yield
    tr = profiling._ACTIVE
    if tr is not None:
        tr.stop()


@pytest.mark.parametrize("name", ["tiny2d.cg", "tiny2d.direct"])
def test_traced_rehearsal_reads_the_program_spans(name, tmp_path,
                                                  no_trace_left):
    """On the CPU there is no profiled replay, so cg.kernels_per_apply
    reads nothing; the others read the window's program spans."""
    r = run_cell(_cell(name), 2**31 + 9, 0.5, True,
                 t_start=time.perf_counter(), device="cpu",
                 out_dir=str(tmp_path), log=lambda m: None)
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert "cg.kernels_per_apply" not in m
    assert m["bc.apply_ms"] > 0 and m["setup.problem_s"] > 0
    if name == "tiny2d.cg":
        assert m["cg.enqueue_us"] > 0 and m["cg.check_wait_us"] > 0
    else:
        assert "cg.enqueue_us" not in m and "cg.check_wait_us" not in m


def test_a_program_without_a_tracer(monkeypatch):
    """A program whose profiling module has no `tracing`: prepare returns
    None and read returns None, raising nothing."""
    fake = types.ModuleType("pynama_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "pynama_tpu_torch.utils.profiling",
                        fake)
    program = types.SimpleNamespace(problem=types.SimpleNamespace())
    rec = types.SimpleNamespace(spans=[Span("stepper", 0.0, 1.0)],
                                profiled=[], trace=None, steps=1,
                                prepared={})
    for name in NEW:
        mod = reader(name)
        rec.prepared[name] = mod.prepare(program, None)
        assert rec.prepared[name] is None
        assert mod.read(rec) is None
