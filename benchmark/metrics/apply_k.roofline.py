"""apply_k.roofline: the element products of K's share of their roofline,
in percent, over the profiled rhs range: the least time the card could
take for the products the program's `apply_k.element` spans made (each
at its own shape, E and ngl from the span, counted by `counts_hex.py`
from the shape alone, so the share stays on the same work whatever
implements K) over the device time of the records launched inside those
spans, as the profiler times them."""
import counts_hex
import program_trace as pt

SPANS = pt.labels("apply_k.element")


def prepare(program, profile):
    trace = pt.start()
    if trace is None:
        return None
    return {"trace": trace, "dtype": program.cell.config["precision"],
            "dim": program.problem.dim}


def read(rec):
    prep = rec.prepared.get("apply_k.roofline")
    if rec.trace is None or not prep:
        return None
    calls = [r.attrs for r in pt.profiled(rec, prep["trace"])
             if r.name == "apply_k.element"]
    bound = sum(counts_hex.apply_k_bound_s(int(a["E"]), int(a["ngl"]),
                                           prep["dim"], prep["dtype"])
                for a in calls)
    t = rec.trace.device_s(span="apply_k.element")
    return 100.0 * bound / t if t > 0 and bound > 0 else None
