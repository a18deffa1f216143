"""cg.check_wait_us: host microseconds per CG loop application spent in
the stop checks: the program's `pcg.check` spans (the host's read of the
device flag `run` every `check_every` iterations, which waits for the
device to finish all that is queued before it) summed over the window,
over the loop applications the window's CG `kle.solve` spans counted."""
import program_trace as pt

SPANS = pt.labels("kle.solve", "pcg.check")


def prepare(program, profile):
    return pt.start()


def read(rec):
    recs = pt.window(rec, rec.prepared.get("cg.check_wait_us"))
    applies = pt.cg_loop_applies(recs)
    wait = sum(r.seconds for r in recs if r.name == "pcg.check")
    return 1e6 * wait / applies if applies else None
