"""dss.gather_us: device microseconds per gather DSS over the profiled
rhs range: the profiler's time of every device record launched inside
the program's `dss.gather` spans (engine/local_engine.py _dss on an
unstructured mesh: after every operator application, K's in each CG
iteration among them), over the number of those spans."""
import program_trace as pt

SPANS = pt.labels("dss.gather")


def prepare(program, profile):
    return pt.start()


def read(rec):
    calls = sum(1 for r in pt.profiled(rec, rec.prepared.get(
        "dss.gather_us")) if r.name == "dss.gather")
    if rec.trace is None or not calls:
        return None
    t = rec.trace.device_s(span="dss.gather")
    return 1e6 * t / calls if t > 0 else None
