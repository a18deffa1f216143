"""rhs.self_ms: wall milliseconds per rhs evaluation outside its KLE
solves: each `rhs` span minus the `cg` and `direct` spans directly inside
it (BC writes, curl between the stages, srt, v(x)v, div_srt, curl), the
mean over the window's rhs evaluations."""

SPANS = {"rhs": {"targets": [
    ("pynama_tpu_torch.cases.problem", "rhs_local"),
    ("pynama_tpu_torch.cases.problem", "Problem.rhs")]},
    "cg": {"targets": [
        ("pynama_tpu_torch.engine.local_engine", "pcg"),
        ("pynama_tpu_torch.solver.kle", "pcg")],
        "info": ("loop_applies", "iters")},
    "direct": {"targets": [
        ("pynama_tpu_torch.solver.kle", "_masked_solve", (2, "method",
                                                          "direct"))]}}


def read(rec):
    spans = rec.spans
    own = {i: s.seconds for i, s in enumerate(spans) if s.name == "rhs"}
    if not own:
        return None
    for s in spans:
        if s.name in ("cg", "direct") and s.parent in own:
            own[s.parent] -= s.seconds
    return 1e3 * sum(own.values()) / len(own)
