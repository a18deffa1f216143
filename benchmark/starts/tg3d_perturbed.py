"""The start state of the 3D Taylor-Green case: its own analytic field at
t = 0 (this module's copy of the `taylor_green3d` formula: the unit box,
alpha = 1), with the mix's seeded perturbation of the vorticity on top
(`harness/traffic.py`: sine modes 1..`modes` per axis, zero on every wall
of the unit cube, so the walls keep the case's values) at
`amplitude` times the field's peak vorticity, 6 pi. The velocity is the
field's own. A case whose initial conditions are not this field is
refused, so a configuration that names this builder wrongly fails at
once."""
from __future__ import annotations

import numpy as np

from harness.traffic import perturbation

#: the peak of each vorticity component of the unit-box field, 2 pi (1 + 2)
PEAK_VORTICITY = 6 * np.pi


def taylor_green3d(coords):
    """(velocity, vorticity) (n, 3) float64 of the field at t = 0."""
    x, y, z = (2 * np.pi * coords[:, d] for d in range(3))
    vel = np.stack([np.cos(x) * np.sin(y) * np.sin(z),
                    np.sin(x) * np.cos(y) * np.sin(z),
                    -2 * np.sin(x) * np.sin(y) * np.cos(z)], axis=1)
    vort = np.stack([-PEAK_VORTICITY * np.sin(x) * np.cos(y) * np.cos(z),
                     PEAK_VORTICITY * np.cos(x) * np.sin(y) * np.cos(z),
                     np.zeros_like(x)], axis=1)
    return vel, vort


def build(case: dict, coords, mix: dict, seed: int):
    """(vorticity (n, 3), velocity (n, 3)) float64 on `coords`."""
    ic = case.get("initial-conditions", {})
    name = ic.get("custom-func", {}).get("name")
    if name != "taylor_green3d":
        raise ValueError(f"case {case.get('name')!r} does not start from "
                         f"the taylor_green3d field: initial-conditions {ic}")
    coords = np.asarray(coords, dtype=np.float64)
    vel, vort = taylor_green3d(coords)
    p = mix["perturbation"]
    vort = vort + perturbation(coords, np.zeros(3), np.ones(3), 3, seed,
                               p["amplitude"] * PEAK_VORTICITY, p["modes"])
    return vort, vel
