"""Measurement experiments, analyses and validation runs: the port's
counterparts of the JAX package's `exp/` drivers.

Kernel decomposition, on the card's hand-written kernels:
- `fused_decomp`: K3 `variant_apply` and K4 `plainmm_apply`, and a driver
  that times fused_apply against its parts (DSS pass, seam adds, the hand
  GEMM against torch.matmul).
- `mm3x`: K2 `fused3x_apply`, the fused apply with a 3-pass split-bf16
  tensor-core GEMM, and a driver that checks and times it.

Measurement drivers (each checks that its variants agree, then times
them):
- `fused_ab`: the engine's apply_K through K1 against the plain
  ops/local.py route, 24^3 ngl=4.
- `ngl7_blocks`: K1 at 8^3 ngl=7 (1029 -> 1029) against emm + dss, as a
  share of the card's f32 FFMA peak.
- `sumfact_chip`: the sum-factorized K against the dense per-element K on
  bench.py's 10^3 distorted hexes.
- `sumfact_roofline`: the sumfact product split into its gradient
  matmuls, stiffness contraction and penalty chain, beside its roofline.
- `dss_gather_opt`: the gather DSS against its column-major
  trailing-gather form.
- `solve_overhead`: the warm two-stage KLE solve in units of K applies.

FS-stage analyses (dense linear algebra on the device, float64 by
default):
- `fs_spectrum`: Jacobi- and FDM-preconditioned spectra of the condensed
  FS and main-stage operators, k-drop tables and low-mode census.
- `fs_walls`: additive wall-block, Schur and per-face slab corrections.
- `fs_woodbury`: K = S + B^T B in quadrature space, its G operator's
  spectra and actual PCG iteration counts.

Validation runs:
- `cavity_re100`: the 2D lid-driven cavity at Re=100 marched to steady
  state, its centerline profiles (held against Ghia, Ghia & Shin 1982 and
  the JAX package's artifact in tests/test_torch_cavity_re100.py).
- `ibm_cd`: the static cylinder's drag histories at three resolutions
  (held against the JAX package's in tests/test_torch_ibm_cd.py).

The drivers share the helpers below: the same inputs (numpy, seed 0), the
same chain `y = fn(x); x = y / (1 + max|y|)` ending in one host read, and
variants timed interleaved round-robin, each keeping its minimum over the
rounds (`time_variants`: one chain length; `interleaved_slopes`: the
slope between a short and a long chain). The device is explicit: asking
for cuda without a card raises.
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

#: H100 SXM data sheet: HBM3 bytes/s and the f32 FLOP/s outside the tensor
#: cores (FFMA), the rates the measurement drivers put their times beside
HBM_BPS = 3.35e12
PEAK_F32 = 67e12


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


def _host_read(out) -> float:
    """The first element of `out` (a tensor, or a tuple whose first item
    is one) read on the host: the chain's one synchronization."""
    while isinstance(out, (tuple, list)):
        out = out[0]
    return float(out.reshape(-1)[0])


def interleaved_slopes(specs, n1: int = 400, target_s: float = 1.0,
                       rounds: int = 5) -> dict:
    """Round-robin slope timing of competing variants (the protocol of the
    JAX package's bench.py `interleaved_slopes`).

    specs: (name, make_chain, args) triples; make_chain(n) returns a
    function of *args that runs an n-step chain and returns its last
    tensor. Each variant's long chain is sized from a timed short chain so
    that it takes about target_s (at most ~2.5 s). Each round times every
    variant's short then long chain, each ending in one host read; the
    time per step is the slope between the minimum times over the rounds,
    or the long chain's mean step where jitter makes that slope <= 0.
    A variant that fails raises: no variant is dropped.

    Returns name -> (seconds per step, short-chain minimum seconds)."""
    state = {}
    for name, make_chain, args in specs:
        fn1 = make_chain(n1)
        _host_read(fn1(*args))                     # warm
        t0 = time.perf_counter()
        _host_read(fn1(*args))
        per = max((time.perf_counter() - t0) / n1, 1e-7)
        n2 = int(np.clip(target_s / per, 2 * n1, 200000))
        n2 = min(n2, max(int(2.5 / per), 2 * n1))
        state[name] = dict(fns=(fn1, make_chain(n2)), n=(n1, n2),
                           t=[np.inf, np.inf], args=args)
    for _ in range(rounds):
        for st in state.values():
            for i, fn in enumerate(st["fns"]):
                t0 = time.perf_counter()
                _host_read(fn(*st["args"]))
                st["t"][i] = min(st["t"][i], time.perf_counter() - t0)
    out = {}
    for name, st in state.items():
        (t1, t2), (m1, m2) = st["t"], st["n"]
        slope = (t2 - t1) / (m2 - m1)
        if slope <= 0:
            slope = t2 / m2
        out[name] = (max(slope, 1e-9), t1)
    return out


def write_hex_msh(path: str, nx: int, ny: int, nz: int,
                  distort: float) -> str:
    """The JAX package's bench.py `_write_hex_msh`, to `path`: an nx x ny
    x nz grid of hexes on [0,1]^3 as MSH 2.2, interior vertices moved by
    uniform(-1, 1) * distort / nx per coordinate from numpy's
    default_rng(0), boundary quads in the physical groups
    down/right/up/left/back/front. Returns path."""
    xs = [np.linspace(0, 1, n + 1) for n in (nx, ny, nz)]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1)
    rng = np.random.default_rng(0)
    interior = np.all((verts > 1e-12) & (verts < 1 - 1e-12), axis=1)
    verts[interior] += (rng.uniform(-1, 1, (int(interior.sum()), 3))
                        * distort / nx)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    hexes = [[vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k),
              vid(i, j + 1, k), vid(i, j, k + 1), vid(i + 1, j, k + 1),
              vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1)]
             for i in range(nx) for j in range(ny) for k in range(nz)]
    names = ["down", "right", "up", "left", "back", "front"]
    quads = {
        "down": [[vid(i, 0, k), vid(i + 1, 0, k), vid(i + 1, 0, k + 1),
                  vid(i, 0, k + 1)] for i in range(nx) for k in range(nz)],
        "up": [[vid(i, ny, k), vid(i + 1, ny, k), vid(i + 1, ny, k + 1),
                vid(i, ny, k + 1)] for i in range(nx) for k in range(nz)],
        "left": [[vid(0, j, k), vid(0, j + 1, k), vid(0, j + 1, k + 1),
                  vid(0, j, k + 1)] for j in range(ny) for k in range(nz)],
        "right": [[vid(nx, j, k), vid(nx, j + 1, k), vid(nx, j + 1, k + 1),
                   vid(nx, j, k + 1)] for j in range(ny) for k in range(nz)],
        "back": [[vid(i, j, 0), vid(i + 1, j, 0), vid(i + 1, j + 1, 0),
                  vid(i, j + 1, 0)] for i in range(nx) for j in range(ny)],
        "front": [[vid(i, j, nz), vid(i + 1, j, nz), vid(i + 1, j + 1, nz),
                   vid(i, j + 1, nz)] for i in range(nx) for j in range(ny)],
    }
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$PhysicalNames\n"
                f"{len(names) + 1}\n")
        for t, n in enumerate(names):
            f.write(f'2 {t + 1} "{n}"\n')
        f.write(f'3 {len(names) + 1} "volume"\n$EndPhysicalNames\n$Nodes\n'
                f"{len(verts)}\n")
        for i, v in enumerate(verts):
            f.write(f"{i + 1} {v[0]} {v[1]} {v[2]}\n")
        f.write("$EndNodes\n$Elements\n")
        f.write(f"{sum(len(v) for v in quads.values()) + len(hexes)}\n")
        eid = 1
        for t, n in enumerate(names):
            for q in quads[n]:
                f.write(f"{eid} 3 2 {t + 1} {t + 1} "
                        + " ".join(str(x + 1) for x in q) + "\n")
                eid += 1
        for h in hexes:
            f.write(f"{eid} 5 2 {len(names) + 1} {len(names) + 1} "
                    + " ".join(str(x + 1) for x in h) + "\n")
            eid += 1
        f.write("$EndElements\n")
    return path


def peak_memory(dev: torch.device):
    """torch.cuda.max_memory_allocated on a card (bytes), None on the
    CPU."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def analysis_main(argv, prog: str, doc: str, analyze, sizes: list,
                  ngl_option: bool = False) -> list:
    """The command line of an FS-stage analysis: `[ne ...] [--ngl N]
    [--device cuda] [--dtype float64]`. Runs `analyze(ne, ngl, device=,
    dtype=)` for each size, then prints its record as one JSON line with
    the wall seconds and the device's peak memory; returns the records."""
    from pynama_tpu_torch.run_case import DTYPES
    ap = argparse.ArgumentParser(prog=prog, description=doc.split("\n\n")[0])
    ap.add_argument("sizes", nargs="*", type=int, default=sizes,
                    help="elements per axis, one analysis each")
    if ngl_option:
        ap.add_argument("--ngl", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float64", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    results = []
    for ne in args.sizes:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        rec = analyze(ne, getattr(args, "ngl", 4), device=dev,
                      dtype=DTYPES[args.dtype])
        rec.update(wall_s=time.perf_counter() - t0,
                   peak_mem_bytes=peak_memory(dev),
                   device=device_name(dev), dtype=args.dtype)
        print(json.dumps(rec), flush=True)
        results.append(rec)
    return results
