"""cg.iters_per_solve: CG iterations per KLE solve, the mean over every
solve of the window's replays (both stages): the iteration count each
`pcg` call returns (a device tensor, read after the window)."""

SPANS = {"cg": {"targets": [
    ("pynama_tpu_torch.engine.local_engine", "pcg"),
    ("pynama_tpu_torch.solver.kle", "pcg")],
    "info": ("loop_applies", "iters")}}


def read(rec):
    its = [int(s.info["iters"]) for s in rec.spans if s.name == "cg"]
    return sum(its) / len(its) if its else None
