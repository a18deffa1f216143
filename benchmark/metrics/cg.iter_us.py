"""cg.iter_us: wall microseconds per CG loop application: the summed
length of the harness's `cg` spans around `pcg` (synchronized at both
ends) over the loop applications those calls report. The host-bound
iteration shows here before it shows in step_s."""

SPANS = {"cg": {"targets": [
    ("pynama_tpu_torch.engine.local_engine", "pcg"),
    ("pynama_tpu_torch.solver.kle", "pcg")],
    "info": ("loop_applies", "iters")}}


def read(rec):
    cg = [s for s in rec.spans if s.name == "cg"]
    applies = sum(s.info["loop_applies"] for s in cg)
    return 1e6 * sum(s.seconds for s in cg) / applies if applies else None
