"""One run of one cell: set-up, the measured window, the traced window, the
check against the reference, and the result line.

Every piece is the one the cell's files name (`spec.py`): the program
module sets up the measured solver and replays the segment, the start
builder gives the seed's start state, the metric modules read the
per-layer numbers, and the reference module judges the answers.

Set-up (`setup_s`, from the process's start): imports, the program's
set-up for the cell's config and mix, the seed's start state, and one
warm rhs at that state, which builds (first run in a checkout) or loads
K1 and touches every shape the window uses.

Window: the segment replayed from the same start state, whole replays
only, as long as another one of the last one's length fits into
`seconds` (at least one); each replay ends with its fields copied to the
host (the answers). `step_s` is the window's wall seconds over all the
accepted steps it completed.

With trace=True each metric module's `prepare` runs after set-up, the
window runs with a span around each layer call the cell's modules declare
(`spans.py`, synchronizing at both ends), and afterwards one more replay
runs with the profiler on over the mix's `trace_rhs` range of rhs
evaluations (`trace.py`); the metric modules read what they need from
`rec` (window spans, the profiled replay's spans, the trace, what
`prepare` returned).
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
import types

import torch

from harness import check
from harness.spans import Spans, layer_spans, merge
from harness.trace import Profiler

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pynama_tpu")


class _TraceDone(Exception):
    """Ends the traced replay once its rhs range has been profiled."""


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, out_dir: str, log=print) -> dict:
    """The result object of one run (see the benchmark's contract)."""
    dev = torch.device(device or "cuda:0")
    mix = cell.mix
    t_imports = time.perf_counter() - t_start
    program = cell.piece("program")
    prog = program.Program(cell, dev)
    prog.load(*check.start_state(cell, prog.coords, seed))
    prog.warm()
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: {prog.describe()}; imports "
        f"{t_imports:.3f} s")

    readers = {m["name"]: cell.metric(m["name"]) for m in cell.per_layer} \
        if trace else {}
    decls = merge([getattr(program, "SPANS", {})]
                  + [getattr(r, "SPANS", {}) for r in readers.values()])
    prof = None
    if trace and dev.type == "cuda":
        prof = Profiler(os.path.join(out_dir, cell.name),
                        ("stepper", *decls))
    prepared = {name: r.prepare(prog, prof.run if prof else None)
                for name, r in readers.items() if hasattr(r, "prepare")}

    spans = Spans(sync=True)
    answers, steps = [], 0
    t0 = last = time.perf_counter()
    with (layer_spans(spans, decls) if trace
          else contextlib.nullcontext()):
        while True:
            with (spans.span("stepper") if trace
                  else contextlib.nullcontext()):
                answers.append(prog.replay())
            steps += answers[-1][1]
            now = time.perf_counter()
            # whole replays only; the next one starts if the last one's
            # length still fits before `seconds`
            if now - t0 + (now - last) > seconds:
                break
            last = now
    window_s = time.perf_counter() - t0
    log(f"window {window_s:.3f} s: {len(answers)} replays, {steps} steps")

    traced, profiled = None, []
    if prof is not None:
        traced, profiled = _traced_replay(prog, prof, mix, decls)

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    del prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    verdict = check.judge(cell, answers, seed, dev, log=log)
    rec = types.SimpleNamespace(steps=steps, spans=spans.records,
                                trace=traced, profiled=profiled,
                                prepared=prepared)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"step_s": window_s / max(steps, 1), "setup_s": setup_s,
               "peak_mem_gb": peak / 1e9}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu", "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": verdict["failed"] == 0 and verdict["compared"] > 0,
              "attempted": len(answers), "failed": verdict["failed"],
              "metrics": metrics, "device": info}
    if traced is not None:
        info.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = {"device_ops": traced.top_ops(),
                               "idle_gaps": traced.top_gaps()}
    result["checks"] = {k: {"value": v, "limit": cell.limits[k]}
                        for k, v in verdict["numbers"].items()}
    log(f"reference {verdict['reference_s']:.3f} s")
    return result


def _traced_replay(prog, prof: Profiler, mix, decls):
    """One replay with the profiler on over rhs evaluations [skip, skip +
    count) of the segment, every declared span installed; returns
    (Window, [the spans opened while the profiler ran])."""
    skip, count = mix["trace_rhs"]["skip"], mix["trace_rhs"]["count"]
    spans = Spans(sync=False, annotate=True)
    state = {"rhs": 0, "window": None}

    def on_enter(name):
        if name == "rhs" and state["rhs"] == skip:
            spans.profiling = True
            prof.start()

    def on_exit(rec):
        if rec.name != "rhs":
            return
        state["rhs"] += 1
        if state["rhs"] == skip + count:
            state["window"], spans.profiling = prof.stop(), False
            raise _TraceDone

    spans.on_enter, spans.on_exit = on_enter, on_exit
    try:
        with layer_spans(spans, decls, profiled=True):
            prog.replay()
    except _TraceDone:
        pass
    if state["window"] is None and spans.profiling:   # fewer rhs: stop here
        state["window"], spans.profiling = prof.stop(), False
    return state["window"], [s for s in spans.records if s.profiled]
