"""Measurement experiments and validation runs: the port's counterparts of
the JAX package's `exp/` drivers whose kernels split the fused apply's
time, of its solve-overhead driver, and of its two long-horizon physics
validations.

- `fused_decomp`: K3 `variant_apply` and K4 `plainmm_apply`, and a driver
  that times fused_apply against its parts (DSS pass, seam adds, the hand
  GEMM against torch.matmul).
- `mm3x`: K2 `fused3x_apply`, the fused apply with a 3-pass split-bf16
  tensor-core GEMM, and a driver that checks and times it.
- `solve_overhead`: the warm two-stage KLE solve in units of K applies.
- `cavity_re100`: the 2D lid-driven cavity at Re=100 marched to steady
  state, its centerline profiles (held against Ghia, Ghia & Shin 1982 and
  the JAX package's artifact in tests/test_torch_cavity_re100.py).
- `ibm_cd`: the static cylinder's drag histories at three resolutions
  (held against the JAX package's in tests/test_torch_ibm_cd.py).

The first two drivers share the helpers below: the same inputs (numpy, seed 0), the
same chain `y = fn(x); x = y / (1 + max|y|)` ending in one host read, and
variants timed interleaved round-robin, each keeping its minimum over the
rounds. The device is explicit: asking for cuda without a card raises.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from pynama_tpu_torch.config import device_of  # noqa: F401 (the drivers')


def parse_args(argv, prog: str, description: str, rounds: int):
    ap = argparse.ArgumentParser(prog=prog, description=description)
    ap.add_argument("ne", nargs="?", type=int, default=24,
                    help="elements per axis of the 3D box (default 24)")
    ap.add_argument("ngl", nargs="?", type=int, default=4,
                    help="GLL points per axis (default 4)")
    ap.add_argument("--block", type=int, default=1,
                    help="axis-0 slices per block; must divide ne")
    ap.add_argument("--nit", type=int, default=2000,
                    help="applies per timed chain")
    ap.add_argument("--rounds", type=int, default=rounds,
                    help="interleaved timing rounds (min over them)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain versions")
    return ap.parse_args(argv)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def card_record(dev: torch.device) -> dict:
    """The device a validation run ran on: torch's name for it and, on a
    card, `nvidia-smi --query-gpu=name,power.limit` (a card set below its
    maximum power runs slower under load)."""
    if dev.type != "cuda":
        return {"device": "cpu", "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip() if smi.returncode == 0 else None
    return {"device": torch.cuda.get_device_name(dev), "nvidia_smi": line}


def write_json(path: str, doc: dict) -> None:
    """Write doc to path through a temporary file, so that a run killed
    while writing leaves the previous artifact whole."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def inputs(ne: int, ngl: int, ncomp: int, dev: torch.device):
    """(t, matT) of the 3D ne^3 box, float32, from numpy seed 0."""
    nnc = ngl ** 3 * ncomp
    rng = np.random.default_rng(0)
    t = torch.as_tensor(rng.standard_normal((ne ** 3, nnc)),
                        dtype=torch.float32, device=dev)
    matT = torch.as_tensor(rng.standard_normal((nnc, nnc)) / nnc,
                           dtype=torch.float32, device=dev)
    return t, matT


def run_chain(fn, t, m, nit: int) -> float:
    x = t
    for _ in range(nit):
        y = fn(x, m)
        x = y / (1.0 + y.abs().max())
    return float(x.reshape(-1)[0])     # the one host read (synchronizes)


def time_variants(variants: dict, t, m, nit: int, rounds: int) -> dict:
    """Seconds per apply of each variant: min over `rounds` interleaved
    rounds of one `nit`-apply chain each, after a short warm chain."""
    for name, fn in variants.items():
        tw = time.perf_counter()
        run_chain(fn, t, m, min(nit, 20))
        print(f"warm {name} ({time.perf_counter() - tw:.1f}s)", flush=True)
    best = {k: np.inf for k in variants}
    for r in range(rounds):
        for name, fn in variants.items():
            t1 = time.perf_counter()
            run_chain(fn, t, m, nit)
            best[name] = min(best[name], (time.perf_counter() - t1) / nit)
        print(f"round {r}: " + "  ".join(
            f"{k}={best[k] * 1e6:.1f}us" for k in variants), flush=True)
    return best
