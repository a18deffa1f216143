"""ibm.cg_iter_us: wall microseconds of the correction CG per loop
iteration: the program's `ibm.cg` spans (no synchronize at their start;
the loop's own reads of its condition every 8 iterations wait for the
card) summed over the window, over the operator applications their
loops made (`loop_applies`)."""
import program_trace as pt


def prepare(program, profile):
    return pt.start()


def read(rec):
    spans = [r for r in pt.window(rec, rec.prepared.get("ibm.cg_iter_us"))
             if r.name == "ibm.cg"]
    applies = sum(r.attrs["loop_applies"] for r in spans)
    return 1e6 * sum(r.seconds for r in spans) / applies if applies \
        else None
