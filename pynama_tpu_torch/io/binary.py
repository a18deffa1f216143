"""Raw-binary field snapshots on the native async writer.

High-frequency output path: each `save()` hands the field buffer to the
C++ background writer (pynama_tpu_torch/native) and returns immediately,
so the solve loop never blocks on disk — the async analog of the reference's
synchronous per-step PETSc HDF5 dumps (`src/viewer/paraviewer.py:40-66`,
`base_problem.py:93-103`). A JSON manifest records dtype/shape/time per
snapshot; `load_snapshot()` reads any snapshot back.

Use `Paraviewer` (io/viewer.py) for ParaView-compatible HDF5/XDMF output;
use this for fast production dumps and post-processing pipelines.
"""
from __future__ import annotations

import json
import os

import numpy as np

from pynama_tpu_torch.native import AsyncBinaryWriter


class BinarySnapshotWriter:
    def __init__(self, save_dir: str, max_queue: int = 4):
        self.save_dir = str(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self._w = AsyncBinaryWriter(max_queue=max_queue)
        self._manifest = {"snapshots": []}

    @property
    def is_async(self) -> bool:
        return self._w.is_async

    def _path(self, name: str, step: int) -> str:
        return os.path.join(self.save_dir, f"{name}-{step:08d}.bin")

    def save(self, step: int, t: float, **fields):
        """Queue each named field for background writing."""
        rec = {"step": int(step), "t": float(t), "fields": {}}
        for name, arr in fields.items():
            a = np.ascontiguousarray(arr)
            path = self._path(name, step)
            self._w.submit(path, a)
            rec["fields"][name] = {
                "file": os.path.basename(path),
                "dtype": str(a.dtype), "shape": list(a.shape)}
        self._manifest["snapshots"].append(rec)

    def flush(self):
        """Block until every queued snapshot is on disk, then write the
        manifest."""
        self._w.flush()
        with open(os.path.join(self.save_dir, "manifest.json"), "w") as f:
            json.dump(self._manifest, f, indent=1)

    def close(self):
        self.flush()
        self._w.close()


def convert_to_paraview(save_dir: str, viewer) -> int:
    """Convert every binary snapshot in `save_dir` to the Paraviewer
    HDF5/XDMF layout (post-hoc: the solve loop paid only the async binary
    writes). Returns the number of converted snapshots."""
    with open(os.path.join(save_dir, "manifest.json")) as f:
        manifest = json.load(f)
    n = 0
    for rec in manifest["snapshots"]:
        fields = {}
        for name, meta in rec["fields"].items():
            data = np.fromfile(os.path.join(save_dir, meta["file"]),
                               dtype=np.dtype(meta["dtype"]))
            fields[name] = data.reshape(meta["shape"])
        viewer.save_data(rec["step"], rec["t"], **fields)
        n += 1
    return n


def load_snapshot(save_dir: str, step: int, name: str) -> np.ndarray:
    with open(os.path.join(save_dir, "manifest.json")) as f:
        manifest = json.load(f)
    for rec in manifest["snapshots"]:
        if rec["step"] == step and name in rec["fields"]:
            meta = rec["fields"][name]
            data = np.fromfile(os.path.join(save_dir, meta["file"]),
                               dtype=np.dtype(meta["dtype"]))
            return data.reshape(meta["shape"])
    raise KeyError(f"snapshot step={step} field={name} not found")
