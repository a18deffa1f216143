"""stepper.rhs_per_step: rhs evaluations per accepted step over the
window's replays (8 per attempt of the 5(4) pair, so rejected attempts
show as more than 8). Counts the harness's `rhs` spans around the rhs
callable the stepper calls."""

SPANS = {"rhs": {"targets": [
    ("pynama_tpu_torch.cases.problem", "rhs_local"),
    ("pynama_tpu_torch.cases.problem", "Problem.rhs")]}}


def read(rec):
    n = sum(1 for s in rec.spans if s.name == "rhs")
    return n / rec.steps if n and rec.steps else None
