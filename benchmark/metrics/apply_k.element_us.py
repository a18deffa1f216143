"""apply_k.element_us: device microseconds per element product of K on
the unstructured route over the profiled rhs range: the profiler's time
of every device record launched inside the program's `apply_k.element`
spans (engine/local_engine.py apply_K, the product before the DSS,
whichever computes it), over the number of those spans. A program
without the span reads nothing."""
import program_trace as pt

SPANS = pt.labels("apply_k.element")


def prepare(program, profile):
    return pt.start()


def read(rec):
    calls = sum(1 for r in pt.profiled(rec, rec.prepared.get(
        "apply_k.element_us")) if r.name == "apply_k.element")
    if rec.trace is None or not calls:
        return None
    t = rec.trace.device_s(span="apply_k.element")
    return 1e6 * t / calls if t > 0 else None
