"""ibm.tables_us: device microseconds per rebuild of the moving body's
interpolation tables over the profiled rhs range: the profiler's time of
every device record launched inside the program's `ibm.tables` spans
(cases/ibm.py: the body's coordinates and velocities copied to the card,
`support_tables` and `spread_plan`), over the number of those spans."""
import program_trace as pt

SPANS = pt.labels("ibm.tables")


def prepare(program, profile):
    return pt.start()


def read(rec):
    calls = sum(1 for r in pt.profiled(rec, rec.prepared.get(
        "ibm.tables_us")) if r.name == "ibm.tables")
    if rec.trace is None or not calls:
        return None
    t = rec.trace.device_s(span="ibm.tables")
    return 1e6 * t / calls if t > 0 else None
