"""Checkpoint / resume.

The reference has NO restart capability (output-only, SURVEY §5); this is
the cheap addition it suggests: state = (vorticity, velocity, t, dt, step)
plus the identifying case configuration, stored in one HDF5 file.
"""
from __future__ import annotations

import json

import numpy as np


def save_checkpoint(path: str, vort, vel, t: float, dt: float, step: int,
                    config: dict | None = None):
    import h5py
    with h5py.File(path, "w") as f:
        f.create_dataset("vorticity", data=np.asarray(vort))
        f.create_dataset("velocity", data=np.asarray(vel))
        f.attrs["t"] = float(t)
        f.attrs["dt"] = float(dt)
        f.attrs["step"] = int(step)
        if config is not None:
            f.attrs["config"] = json.dumps(config)


def load_checkpoint(path: str):
    """Returns dict(vorticity, velocity, t, dt, step, config|None)."""
    import h5py
    with h5py.File(path, "r") as f:
        out = {
            "vorticity": np.asarray(f["vorticity"]),
            "velocity": np.asarray(f["velocity"]),
            "t": float(f.attrs["t"]),
            "dt": float(f.attrs["dt"]),
            "step": int(f.attrs["step"]),
            "config": json.loads(f.attrs["config"])
            if "config" in f.attrs else None,
        }
    return out
