"""The program's own spans (pynama_tpu_torch/utils/profiling.py), as the
metric modules that read them get them.

`start()`, called from a module's `prepare` after set-up, starts the
program's tracer, one trace every module shares, or returns None for a
program that has no tracer (then the module reads nothing). The trace
stays on through the synchronized window and the profiled replay. Its
records carry the host's `perf_counter` in nanoseconds, the harness's
spans the same clock in seconds, so the records are told apart by the
harness's spans: `window` keeps those between the first and the last
`stepper` span, `profiled` those within the profiled replay's spans.

`labels(...)` declares program span names for the trace reader to label
device records and idle gaps by: `SPANS` entries with no targets, so the
harness patches nothing for them (`harness/spans.py`), and out of the
window; the names reach the profiler's reader all the same.
"""
from __future__ import annotations

PCG = ("pcg.apply", "pcg.precond", "pcg.update", "pcg.check")


def labels(*names) -> dict:
    """`SPANS` entries that only name program spans."""
    return {n: {"targets": [], "window": False} for n in names}


def start():
    try:
        from pynama_tpu_torch.utils.profiling import tracing
    except ImportError:
        return None
    return tracing()


def _ns(t: float) -> int:
    return round(t * 1e9)


def window(rec, trace) -> list:
    st = [s for s in rec.spans if s.name == "stepper"]
    if trace is None or not st:
        return []
    return trace.records(_ns(st[0].t0), _ns(st[-1].t1))


def profiled(rec, trace) -> list:
    if trace is None or not rec.profiled:
        return []
    return trace.records(_ns(min(s.t0 for s in rec.profiled)),
                         _ns(max(s.t1 for s in rec.profiled)))


def cg_loop_applies(records) -> int:
    """The CG loop applications of the `kle.solve` spans among records,
    as the loop counted them."""
    return sum(r.attrs["loop_applies"] for r in records
               if r.name == "kle.solve" and r.attrs.get("method") == "cg")
