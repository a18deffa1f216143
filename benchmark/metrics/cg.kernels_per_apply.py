"""cg.kernels_per_apply: device records (kernels, copies, sets) that `pcg`
launches per CG loop application, over the profiled rhs range: the
records the trace labels by a program `pcg.*` span, or by the harness's
`fdm` span, which opens inside `pcg.precond` (cavity3d.fdm), over the loop
applications the profiled range's CG `kle.solve` spans counted. A count:
it does not drift with the host, and a CUDA graph's capture keeps it."""
import program_trace as pt

SPANS = pt.labels("kle.solve", *pt.PCG)


def prepare(program, profile):
    return pt.start()


def read(rec):
    recs = pt.profiled(rec, rec.prepared.get("cg.kernels_per_apply"))
    applies = pt.cg_loop_applies(recs)
    if rec.trace is None or not applies:
        return None
    n = sum(1 for r in rec.trace.records if r.span in pt.PCG
            or r.span == "fdm")
    return n / applies if n else None
