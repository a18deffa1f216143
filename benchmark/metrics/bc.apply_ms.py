"""bc.apply_ms: host milliseconds per rhs evaluation in its BC writes: the
program's `rhs.bc` spans (each write of the KLE pre-solve chain:
vorticity, velocity and, after the free-slip stage, the tangential
velocity; in `bc/conditions.py` on the global route, in the engine's
`apply_*_bc` on the element-local one) summed over the window, over the
window's `rhs.eval` spans. No synchronize: where a write copies from
pageable host memory the copy's wait shows here. The labels also split an
rhs's device records and idle gaps into its BC writes, its KLE solves and
the rest."""
import program_trace as pt

SPANS = pt.labels("rhs.eval", "rhs.bc", "kle.solve")


def prepare(program, profile):
    return pt.start()


def read(rec):
    recs = pt.window(rec, rec.prepared.get("bc.apply_ms"))
    n = sum(1 for r in recs if r.name == "rhs.eval")
    bc = sum(r.seconds for r in recs if r.name == "rhs.bc")
    return 1e3 * bc / n if n else None
