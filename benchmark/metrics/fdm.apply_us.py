"""fdm.apply_us: device microseconds per FDM preconditioner application
over the profiled rhs range: the profiler's time of every device record
launched inside the harness's `fdm` spans around `fdm_apply`, over the
number of those calls. (FDM's kernels are generic PyTorch kernels that
the CG vector work launches too, so they are told apart by the span that
launched them, not by name.) The span sits inside every CG iteration, so
it is installed in the profiled replay only, not in the synchronized
window."""

SPANS = {"fdm": {"targets": [
    ("pynama_tpu_torch.engine.local_engine", "fdm_apply")],
    "window": False}}


def read(rec):
    calls = sum(1 for s in rec.profiled if s.name == "fdm")
    if rec.trace is None or not calls:
        return None
    t = rec.trace.device_s(span="fdm")
    return 1e6 * t / calls if t > 0 else None
