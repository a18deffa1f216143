"""The one traffic generator: a cell's start state from its mix and a seed.

Every run starts from the case at rest plus a smooth perturbation of the
initial vorticity: `modes` sine modes per axis, each component with its
own coefficients drawn from the seed (standard normal), scaled so the
field never exceeds `amplitude` anywhere. The modes vanish on every wall
of the box, so the walls keep their values. The same seed gives the same
field on any node set; the program and the reference each evaluate it on
their own nodes. The box is the case's box mesh, or else the nodes'
bounding box.
"""
from __future__ import annotations

import itertools

import numpy as np


def perturbation(coords: np.ndarray, lower, upper, dim_w: int, seed: int,
                 amplitude: float, modes: int) -> np.ndarray:
    """(n_nodes, dim_w) float64 initial vorticity at `coords` (n, dim)."""
    coords = np.asarray(coords, dtype=np.float64)
    dim = coords.shape[1]
    x = (coords - np.asarray(lower, float)) / (np.asarray(upper, float)
                                               - np.asarray(lower, float))
    rng = np.random.default_rng(int(seed))
    ms = list(itertools.product(range(1, modes + 1), repeat=dim))
    coef = rng.standard_normal((dim_w, len(ms)))
    coef *= amplitude / np.abs(coef).sum(axis=1, keepdims=True)
    basis = np.stack([np.prod([np.sin(np.pi * m[d] * x[:, d])
                               for d in range(dim)], axis=0)
                      for m in ms], axis=1)              # (n, n_modes)
    return basis @ coef.T


def start_vorticity(case: dict, coords, mix: dict, seed: int) -> np.ndarray:
    """The mix's perturbation of the case's vorticity at `coords`."""
    coords = np.asarray(coords, dtype=np.float64)
    box = case.get("domain", {}).get("box-mesh")
    lower, upper = ((box["lower"], box["upper"]) if box else
                    (coords.min(axis=0), coords.max(axis=0)))
    p = mix["perturbation"]
    return perturbation(coords, lower, upper,
                        1 if coords.shape[1] == 2 else 3, seed,
                        p["amplitude"], p["modes"])
