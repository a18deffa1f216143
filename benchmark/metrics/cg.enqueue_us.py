"""cg.enqueue_us: host microseconds spent issuing one CG loop application:
the program's `pcg.apply`, `pcg.precond` and `pcg.update` spans inside
`solver/cg.py pcg` (no synchronize in or around them), summed over the
window, over the loop applications the window's CG `kle.solve` spans
counted. Near cg.iter_us the iteration is bound by the host's launches;
far under it, by the device or the stop checks (cg.check_wait_us)."""
import program_trace as pt

SPANS = pt.labels("kle.solve", *pt.PCG)


def prepare(program, profile):
    return pt.start()


def read(rec):
    recs = pt.window(rec, rec.prepared.get("cg.enqueue_us"))
    applies = pt.cg_loop_applies(recs)
    issue = sum(r.seconds for r in recs if r.name in pt.PCG
                and r.name != "pcg.check")
    return 1e6 * issue / applies if applies else None
