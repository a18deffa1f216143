"""direct.solve_us: wall microseconds per direct KLE solve (right-hand
side, then the two triangular solves with the Cholesky factor): the mean
length of the harness's `direct` spans around solver/kle.py's
`_masked_solve` of a direct system, synchronized at both ends."""

SPANS = {"direct": {"targets": [
    ("pynama_tpu_torch.solver.kle", "_masked_solve", (2, "method",
                                                      "direct"))]}}


def read(rec):
    d = [s.seconds for s in rec.spans if s.name == "direct"]
    return 1e6 * sum(d) / len(d) if d else None
