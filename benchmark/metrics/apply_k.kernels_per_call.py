"""apply_k.kernels_per_call: device records (kernels, copies, sets)
launched inside one of the program's `apply_k.element` spans, over the
profiled rhs range, per span. A count: it does not drift with the host."""
import program_trace as pt

SPANS = pt.labels("apply_k.element")


def prepare(program, profile):
    return pt.start()


def read(rec):
    calls = sum(1 for r in pt.profiled(rec, rec.prepared.get(
        "apply_k.kernels_per_call")) if r.name == "apply_k.element")
    if rec.trace is None or not calls:
        return None
    n = sum(1 for r in rec.trace.records if r.span == "apply_k.element")
    return n / calls if n else None
