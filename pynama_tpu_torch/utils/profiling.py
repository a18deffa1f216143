"""Profiling: the program's own spans, and torch.profiler device traces.

The reference's observability is a datetime Timer plus commented-out
line_profiler hooks (SURVEY §5). Here:

- `span(name)` marks a layer boundary of the hot path (an rhs, its BC
  writes, a KLE solve, the parts of a CG iteration). While no trace is
  active it returns one shared object that does nothing: the cost is a
  module-global read and a call, with nothing allocated and nothing sent
  to the device. `tracing()` starts a trace (or returns the active one)
  and `Trace.stop()` ends it. While a trace is active each span appends a
  record: its name, host times from `time.perf_counter_ns()`, the index of
  the enclosing span, and an `attrs` dict the caller may fill after entry.
  A span adds no synchronization and reads nothing from the device: an
  attribute whose value lives there (a CG iteration count) is stored as
  the tensor and resolved by whoever reads the trace, after the work.
- While a torch.profiler session records, a span is also a
  `record_function` range, so it lands in the Chrome trace as a
  `user_annotation` event on the profiler's clock, and each kernel, copy
  and idle gap there can be put down to the innermost span that launched
  it.
- `device_trace(log_dir)` profiles a block (CPU activity, and CUDA activity
  on a card) with the program's trace on, pads the window with filler
  kernels on a card (the profiler there drops the first and last few
  kernel records of a window), and writes a Chrome trace, the counterpart
  of the JAX package's jax.profiler trace.
"""
from __future__ import annotations

import array
import contextlib
import logging
import os
import time
import types
from typing import NamedTuple

import torch

logger = logging.getLogger("pynama_tpu_torch.profiling")

#: the file device_trace writes inside its log_dir
TRACE_FILE = "trace.json"

#: filler kernels device_trace launches at each end of its window on a card
PAD = 256

_NO_ATTRS = types.MappingProxyType({})
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Discard(dict):
    """The attrs of a span while tracing is off: takes writes, keeps none."""
    __slots__ = ()

    def __setitem__(self, key, value):
        pass


class _Off:
    """What `span` returns while no trace is active. Its __enter__ and
    __exit__ are static, so a `with` on it creates no bound method."""
    __slots__ = ()
    attrs = _Discard()
    __enter__ = staticmethod(lambda: _OFF)
    __exit__ = staticmethod(lambda exc_type, exc, tb: None)


_OFF = _Off()

#: the Trace spans record into, or None (tracing off)
_ACTIVE = None


def span(name: str):
    """A context manager around one layer call: a record of the active
    trace, or the shared no-op while tracing is off."""
    trace = _ACTIVE
    if trace is None:
        return _OFF
    return trace.open(name)


def tracing() -> "Trace":
    """Start the program's trace, or return the one already active."""
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = Trace()
    return _ACTIVE


class Record(NamedTuple):
    """One span of a trace. `t0`, `t1` are `time.perf_counter_ns()` at
    entry and exit; `parent` is the index of the enclosing span, -1 at the
    top."""
    name: str
    t0: int
    t1: int
    parent: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return 1e-9 * (self.t1 - self.t0)


class _Span:
    """An open span of a trace (tracing on)."""
    __slots__ = ("trace", "index", "annotation")

    def __init__(self, trace, index, annotation):
        self.trace, self.index, self.annotation = trace, index, annotation

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self.trace
        tr.t1[self.index] = time.perf_counter_ns()
        tr._stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(exc_type, exc, tb)

    @property
    def attrs(self) -> dict:
        return self.trace.attrs.setdefault(self.index, {})


class Trace:
    """The spans of one trace, kept column by column: a name reference and
    three 8-byte integers per span (about 32 bytes), plus a dict for the
    few spans whose caller fills attrs."""

    def __init__(self):
        self.names: list[str] = []
        self.t0 = array.array("q")
        self.t1 = array.array("q")
        self.parent = array.array("q")
        self.attrs: dict[int, dict] = {}
        self._stack: list[int] = []

    def open(self, name: str) -> _Span:
        i = len(self.names)
        self.names.append(name)
        self.parent.append(self._stack[-1] if self._stack else -1)
        self._stack.append(i)
        self.t1.append(0)
        # only while a profiler records: outside one, record_function
        # still dispatches an op
        annotation = None
        if _profiler_enabled():
            annotation = torch.profiler.record_function(name)
            annotation.__enter__()
        self.t0.append(time.perf_counter_ns())
        return _Span(self, i, annotation)

    def records(self, t0: int | None = None, t1: int | None = None):
        """The closed spans, as Records, that lie within [t0, t1]
        (perf_counter_ns; either end open when None)."""
        out = []
        for i, name in enumerate(self.names):
            a, b = self.t0[i], self.t1[i]
            if b == 0 or (t0 is not None and a < t0) \
                    or (t1 is not None and b > t1):
                continue
            out.append(Record(name, a, b, self.parent[i],
                              self.attrs.get(i, _NO_ATTRS)))
        return out

    def stop(self):
        """End this trace: spans opened from now on record nothing."""
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None


def _pad(buf):
    if buf is not None:
        for _ in range(PAD):
            buf.fill_(1)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block (CPU activity, and CUDA activity when a
    card is present) with the program's trace on, and write a Chrome trace
    to `log_dir`/trace.json. On a card the window is padded at both ends
    with PAD `fill_` kernels on an int16 buffer of its own."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    buf = torch.zeros(256, dtype=torch.int16, device="cuda") if cuda \
        else None
    own = _ACTIVE is None
    trace = tracing()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        _pad(buf)
        yield prof
    finally:
        _pad(buf)
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        if own:
            trace.stop()
        path = os.path.join(log_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        logger.info("device trace written to %s", path)
