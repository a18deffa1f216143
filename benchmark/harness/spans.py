"""Spans around the calls into the solver's layers, from outside.

Which callables are wrapped is declared where it is needed, never here:
each metric module (and the program module, for the spans its own trace
needs) may carry `SPANS`, a dict from a span's name to its declaration

    {"targets": [(module, attribute path[, (arg, attr, value)]), ...],
     "info": (result attribute, ...),     # copied into the span's info
     "window": True}                      # False: profiled replay only

A target is the module global (or class attribute, "Problem.rhs") through
which the solver calls the layer; the optional condition opens the span
only when `getattr(args[arg], attr) == value`. `merge` joins the
declarations of one cell (targets and info united; a span is left out of
the synchronized window when any declaration says so), and
`layer_spans(spans, decls, profiled)` patches the targets and restores
them on exit. The program itself is not edited.

With `sync=True` a span synchronizes the device at both ends, so its
host-clock length is the layer's wall time. With `annotate=True` it is
also a `torch.profiler.record_function` range, which the trace reader
uses to say which layer launched a kernel. `on_enter` / `on_exit`, when
set, are called with the span's name and record (the traced replay starts
and stops the profiler from them); a span opened while `profiling` is set
is marked `profiled`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time

import torch


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float = 0.0
    parent: int | None = None
    info: dict = dataclasses.field(default_factory=dict)
    profiled: bool = False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Spans:
    def __init__(self, sync: bool, annotate: bool = False):
        self.sync, self.annotate = sync, annotate
        self.records: list[Span] = []
        self._stack: list[int] = []
        self.on_enter = self.on_exit = None
        self.profiling = False

    def _wait(self):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        if self.on_enter is not None:
            self.on_enter(name)
        self._wait()
        rec = Span(name, time.perf_counter(),
                   parent=self._stack[-1] if self._stack else None,
                   profiled=self.profiling)
        self.records.append(rec)
        self._stack.append(len(self.records) - 1)
        ctx = torch.profiler.record_function(name) if self.annotate \
            else contextlib.nullcontext()
        try:
            with ctx:
                yield rec
            self._wait()
        finally:
            rec.t1 = time.perf_counter()
            self._stack.pop()
        if self.on_exit is not None:
            self.on_exit(rec)


@contextlib.contextmanager
def _patched(patches):
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, new in patches:
            setattr(obj, attr, new)
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)


def merge(declarations) -> dict:
    """One cell's spans from the `SPANS` dicts of its modules: {name:
    {"targets": [...], "info": (...), "window": bool}}."""
    out = {}
    for decl in declarations:
        for name, d in (decl or {}).items():
            m = out.setdefault(name, {"targets": [], "info": (),
                                      "window": True})
            for t in d["targets"]:
                t = tuple(tuple(x) if isinstance(x, list) else x for x in t)
                if t not in m["targets"]:
                    m["targets"].append(t)
            m["info"] = tuple(dict.fromkeys(m["info"] + tuple(
                d.get("info", ()))))
            m["window"] = m["window"] and d.get("window", True)
    return out


def _owner(module: str, path: str):
    """(object holding the attribute, attribute name) of module:path."""
    obj = importlib.import_module(module)
    *outer, attr = path.split(".")
    for a in outer:
        obj = getattr(obj, a)
    return obj, attr


def _wrapper(spans: Spans, name: str, orig, info, when):
    def run(*a, **k):
        if when is not None and getattr(a[when[0]], when[1]) != when[2]:
            return orig(*a, **k)
        with spans.span(name) as s:
            res = orig(*a, **k)
            s.info.update({k_: getattr(res, k_) for k_ in info
                           if hasattr(res, k_)})
        return res
    return run


@contextlib.contextmanager
def layer_spans(spans: Spans, decls: dict, profiled: bool = False):
    """Install the wrappers of `decls` (from `merge`) for the enclosed
    block: in the synchronized window those with "window" set, in the
    profiled replay (`profiled=True`) all of them."""
    current, patches = {}, []
    for name in sorted(decls):
        d = decls[name]
        if not (profiled or d["window"]):
            continue
        for target in d["targets"]:
            obj, attr = _owner(target[0], target[1])
            key = (id(obj), attr)
            orig = current.get(key, (None, getattr(obj, attr)))[1]
            new = _wrapper(spans, name, orig, d["info"],
                           target[2] if len(target) > 2 else None)
            current[key] = (obj, new)
            patches.append((obj, attr, new))
    with _patched(patches):
        yield spans
