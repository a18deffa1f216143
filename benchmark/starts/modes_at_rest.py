"""The start state of a case that starts at rest: zero velocity, and the
mix's perturbation of the vorticity (`harness/traffic.py`) on the given
nodes. A case whose initial conditions are not at rest is refused, so a
configuration that names this builder wrongly fails at once."""
from __future__ import annotations

import numpy as np

from harness.traffic import start_vorticity


def build(case: dict, coords, mix: dict, seed: int):
    """(vorticity (n, dim_w), velocity (n, dim)) float64 on `coords`."""
    ic = case.get("initial-conditions", {})
    if set(ic) - {"vorticity", "velocity"} or any(
            np.any(np.asarray(v, dtype=float)) for v in ic.values()):
        raise ValueError(f"case {case.get('name')!r} does not start at "
                         f"rest: initial-conditions {ic}")
    coords = np.asarray(coords, dtype=np.float64)
    w = start_vorticity(case, coords, mix, seed)
    return w, np.zeros((coords.shape[0], coords.shape[1]))
