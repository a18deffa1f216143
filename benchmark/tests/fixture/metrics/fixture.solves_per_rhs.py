"""fixture.solves_per_rhs: KLE stage solves per rhs, a metric that only
this fixture defines, with a span no metric of the benchmark declares (it
shows a metric and the layer callable it wraps added by a file of their
own)."""

SPANS = {"stage": {"targets": [
    ("pynama_tpu_torch.engine.local_engine", "_masked_solve")]},
    "rhs": {"targets": [("pynama_tpu_torch.cases.problem", "rhs_local")]}}


def read(rec):
    rhs = sum(1 for s in rec.spans if s.name == "rhs")
    stages = sum(1 for s in rec.spans if s.name == "stage")
    return stages / rhs if rhs else None
