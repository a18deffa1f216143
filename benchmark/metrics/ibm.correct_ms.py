"""ibm.correct_ms: wall milliseconds per velocity correction of the IBM
loop: the harness's `correction` spans (synchronized at both ends) around
the moving body's `_per_step_correction` (cases/ibm.py: the kinematics,
the support tables and the spread plan, the correction CG, the spread,
and the host reads of the CG's count and residual), summed over the
window, over their number: one at the start of each replay and one after
each accepted step."""

SPANS = {"correction": {"targets": [
    ("pynama_tpu_torch.cases.ibm",
     "ImmersedBoundaryDynamic._per_step_correction")]}}


def read(rec):
    spans = [s.seconds for s in rec.spans if s.name == "correction"]
    return 1e3 * sum(spans) / len(spans) if spans else None
