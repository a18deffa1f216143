"""The padded profiler window and what the harness reads from it.

On the H100 machine `torch.profiler` drops the first few kernel records
of a window and now and then a few of the last, so every window is padded
with `PAD` filler kernels (a `fill_` of an int16 buffer of the harness's
own) before and after the work, and the fillers are left out of every
number (the method of the measured package's chip_smoke.py `_profile` /
`_padding`, copied here).

`Window` starts and stops one profiler session with CPU and CUDA activity,
writes its Chrome trace and reads back:

- the device records (kernels, copies, sets) between the last leading
  filler and the first trailing one: the traced window;
- for each record, the harness span (a `record_function` range of
  `spans.py`) that was open on the host when it was launched, through the
  launch's correlation id;
- the union of the records' intervals: the device's busy seconds, and the
  gaps between them, each labelled by the span that launched the record
  ending it.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch

PAD = 256
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Record:
    name: str
    ts: float      # µs on the trace's clock
    dur: float     # µs
    span: str      # the innermost harness span open at launch, or "-"


@dataclasses.dataclass
class Window:
    """What one padded profiler window saw."""
    records: list          # [Record], fillers left out, in start order
    window_s: float
    busy_s: float
    gaps: list             # [(label, seconds)], one per idle gap

    def device_s(self, names=None, span=None) -> float:
        return 1e-6 * sum(r.dur for r in self.records
                          if (names is None or r.name in names)
                          and (span is None or r.span == span))

    def top_ops(self, n=10):
        by = {}
        for r in self.records:
            by[r.name] = by.get(r.name, 0.0) + r.dur * 1e-6
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n=10):
        by = {}
        for label, s in self.gaps:
            by[label] = by.get(label, 0.0) + s
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


class Profiler:
    """Padded torch.profiler windows on one device; `out_dir` receives the
    Chrome trace of each window (one fixed file, overwritten)."""

    def __init__(self, out_dir: str, span_names=()):
        self.out = os.path.join(out_dir, "trace.json")
        os.makedirs(out_dir, exist_ok=True)
        self.span_names = set(span_names)
        self._buf = torch.zeros(256, dtype=torch.int16, device="cuda")
        self.filler = set()
        self._prof = None
        w = self.run(lambda: None)          # a window of fillers alone
        self.filler = {r.name for r in w.records}
        if len(self.filler) != 1:
            raise RuntimeError(f"filler kernels seen as {self.filler}")

    def _pad(self):
        for _ in range(PAD):
            self._buf.fill_(1)

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._pad()

    def stop(self) -> Window:
        self._pad()
        torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(self.out)
        self._prof = None
        return read_trace(self.out, self.filler, self.span_names)

    def run(self, fn) -> Window:
        self.start()
        fn()
        return self.stop()


def _innermost(spans, times):
    """{key: name of the innermost span holding t} for (t, key) in times;
    spans (start, end, name) sorted by start and nested, as one host
    thread opens them."""
    out, stack, j = {}, [], 0
    for t, key in sorted(times):
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1][2] if stack else "-"
    return out


def read_trace(path: str, filler: set, span_names: set) -> Window:
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    launches, dev, spans = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat == "cuda_runtime" and "correlation" in args:
            launches[args["correlation"]] = float(e["ts"])
        elif cat == "user_annotation" and e.get("name") in span_names:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          e["name"]))
    spans.sort()
    dev.sort(key=lambda e: float(e["ts"]))
    work = [i for i, e in enumerate(dev) if e["name"] not in filler]
    if not work:
        return Window([], 0.0, 0.0, [])
    first, last = work[0], work[-1]
    lead = [float(e["ts"]) + float(e["dur"]) for e in dev[:first]
            if e["name"] in filler]
    trail = [float(e["ts"]) for e in dev[last + 1:] if e["name"] in filler]
    body = [e for e in dev[first:last + 1] if e["name"] not in filler]
    at = [launches.get((e.get("args") or {}).get("correlation"))
          for e in body]
    label = _innermost(spans, [(t, i) for i, t in enumerate(at)
                               if t is not None])
    recs = [Record(e["name"], float(e["ts"]), float(e["dur"]),
                   label.get(i, "-")) for i, e in enumerate(body)]
    w0 = max(lead) if lead else recs[0].ts
    w1 = min(trail) if trail else max(r.ts + r.dur for r in recs)
    busy, gaps, end = 0.0, [], w0
    for r in recs:
        s, t = max(r.ts, w0), min(r.ts + r.dur, w1)
        if s > end:
            gaps.append((f"{r.span}: {r.name[:48]}", (s - end) * 1e-6))
        if t > end:
            busy += t - max(s, end)
            end = t
    if w1 > end:
        gaps.append(("-: window end", (w1 - end) * 1e-6))
    return Window(recs, (w1 - w0) * 1e-6, busy * 1e-6, gaps)
