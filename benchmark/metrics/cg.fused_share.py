"""cg.fused_share: the share, in %, of the window's CG loop applications
(`program_trace.cg_loop_applies`) made by `kle.solve` spans whose
`epilogue` attribute reads "fused": the loops that ran through the fused
epilogue kernels of `ops/cg_epilogue.py` rather than pcg's eager update.
A program whose solves carry no `epilogue` attribute reads nothing."""
import program_trace as pt

SPANS = pt.labels("kle.solve")


def prepare(program, profile):
    return pt.start()


def read(rec):
    recs = [r for r in pt.window(rec, rec.prepared.get("cg.fused_share"))
            if r.name == "kle.solve" and r.attrs.get("method") == "cg"]
    applies = pt.cg_loop_applies(recs)
    if not applies or not any("epilogue" in r.attrs for r in recs):
        return None
    fused = pt.cg_loop_applies([r for r in recs
                                if r.attrs.get("epilogue") == "fused"])
    return 100.0 * fused / applies
