"""ibm.cg_kernels_per_iter: device records (kernels, copies, sets)
launched inside the program's `ibm.cg` spans per loop iteration of the
correction CG, over the profiled rhs range: the records the trace
labels by `ibm.cg` (this cell declares no `pcg.*` label, so the loop's
records, its prologue's and its result's keep the label of the span
around them) over the `loop_applies` of the profiled `ibm.cg` spans. A
count: it does not drift with the host."""
import program_trace as pt

SPANS = pt.labels("ibm.cg")


def prepare(program, profile):
    return pt.start()


def read(rec):
    applies = sum(r.attrs["loop_applies"] for r in pt.profiled(
        rec, rec.prepared.get("ibm.cg_kernels_per_iter"))
        if r.name == "ibm.cg")
    if rec.trace is None or not applies:
        return None
    n = sum(1 for r in rec.trace.records if r.span == "ibm.cg")
    return n / applies if n else None
