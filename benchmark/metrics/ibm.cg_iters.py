"""ibm.cg_iters: iterations of the correction CG per correction, the mean
over the window's corrections: the `iters` of the program's `ibm.cg`
spans (ibm/interpolation.py correction_cg, around its `pcg` call), each
the loop's device count, read after the window. The first correction of
a replay starts from a zero flux, the others from the last step's."""
import program_trace as pt


def prepare(program, profile):
    return pt.start()


def read(rec):
    its = [int(r.attrs["iters"]) for r in pt.window(
        rec, rec.prepared.get("ibm.cg_iters")) if r.name == "ibm.cg"]
    return sum(its) / len(its) if its else None
