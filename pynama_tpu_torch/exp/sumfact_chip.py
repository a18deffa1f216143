"""Dense against sum-factorized hex K apply on the device (port of the JAX
package's exp/sumfact_chip.py).

bench.py's gmsh mesh (nx^3 hexes on [0,1]^3, interior vertices distorted
by 0.12 / nx from numpy's default_rng(0), `exp.write_hex_msh`) at ngl=4,
float32, set up through `Problem` twice: `sumfact=True` (the engine's K is
`ops/sumfact.py`'s four shared matmuls and pointwise geometry, then the
gather DSS) and `sumfact=False` (one dense (192, 192) matrix per element,
`emm`, then the gather DSS). It prints the f32 agreement of the two
applies on a numpy-seeded (default_rng(1)) velocity (raising above
max|diff| / max|dense| = 1e-5), then µs per apply of
each as the slope between the min-over-rounds times of a long and a short
chain (`y = apply_K(x); x = y / (1 + max|y|)`, one host read at each
chain's end), interleaved, and the bytes the dense K streams per apply
beside their time at the card's memory rate, 3.35 TB/s (H100 SXM data
sheet).

    python -m pynama_tpu_torch.exp.sumfact_chip [nx] [--ngl 4]
        [--nit 2000 200] [--rounds 6] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from pynama_tpu_torch.cases import Problem
from pynama_tpu_torch.engine import local_engine as E
from pynama_tpu_torch.exp import (HBM_BPS, device_name, device_of,
                                  write_hex_msh)

#: max|sumfact - dense| / max|dense|: the repo's f32 limit (chip_smoke.py's
#: unstructured phase holds the two routes to it too)
AGREE_LIMIT = 1e-5


def hex_config(path: str, ngl: int) -> dict:
    return {"name": "sfchip",
            "material-properties": {"rho": 1.0, "mu": 0.01},
            "domain": {"ngl": ngl, "gmsh-file": path},
            "boundary-conditions": {"uniform": {"velocity": [1, 0, 0],
                                                "vorticity": [0, 0, 0]}},
            "initial-conditions": {"velocity": [1, 0, 0]}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="pynama_tpu_torch.exp.sumfact_chip",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("nx", nargs="?", type=int, default=10)
    ap.add_argument("--ngl", type=int, default=4)
    ap.add_argument("--nit", type=int, nargs=2, default=[2000, 200],
                    metavar=("LONG", "SHORT"), help="chain lengths")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    nx, ngl = args.nx, args.ngl

    probs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = write_hex_msh(os.path.join(tmp, "hex.msh"), nx, nx, nx,
                             distort=0.12)
        for name, sf_on in (("sumfact", True), ("dense", False)):
            t0 = time.time()
            q = Problem(hex_config(path, ngl), device=dev,
                        dtype=torch.float32, solver="cg", cg_rtol=1e-6,
                        cg_maxiter=500, engine=True, sumfact=sf_on)
            q.setUp()
            probs[name] = q
            print(f"setup {name}: {time.time()-t0:.1f}s "
                  f"({q.mesh.n_cells} cells)", flush=True)

    q0 = probs["dense"]
    rng = np.random.default_rng(1)
    v = q0.to_local(rng.standard_normal((q0.mesh.n_nodes, 3)))

    # agreement on the device (f32): sumfact vs dense apply
    ya = E.apply_K(probs["sumfact"].engine_ops, v)
    yb = E.apply_K(probs["dense"].engine_ops, v)
    diff = float((ya - yb).abs().max())
    scale = float(yb.abs().max())
    print(f"on-device f32 agreement: max abs diff {diff:.3e} "
          f"(scale {scale:.3e})", flush=True)
    if not diff <= AGREE_LIMIT * scale:
        raise RuntimeError(f"sumfact_chip: sumfact and dense K applies "
                           f"differ by {diff / scale:.3e} > {AGREE_LIMIT}")

    def run(ops, n):
        x = v
        for _ in range(n):
            y = E.apply_K(ops, x)
            x = y / (1.0 + y.abs().max())
        return float(x.reshape(-1)[0])            # the one host read

    for k, q in probs.items():
        tw = time.time()
        run(q.engine_ops, 50)
        print(f"warm {k} ({time.time()-tw:.1f}s)", flush=True)

    nit_l, nit_s = args.nit
    mins = {k: {"l": np.inf, "s": np.inf} for k in probs}
    per = {}
    for r in range(args.rounds):
        for k, q in probs.items():
            for tag, n in (("l", nit_l), ("s", nit_s)):
                t1 = time.perf_counter()
                run(q.engine_ops, n)
                mins[k][tag] = min(mins[k][tag], time.perf_counter() - t1)
        for k in probs:
            per[k] = (mins[k]["l"] - mins[k]["s"]) / (nit_l - nit_s)
        print(f"round {r}: " + "  ".join(
            f"{k}={per[k]*1e6:.0f}us" for k in probs), flush=True)

    E_cells = q0.mesh.n_cells
    nnd = ngl ** 3 * 3
    dense_bytes = E_cells * nnd * nnd * 4
    bound_us = dense_bytes / HBM_BPS * 1e6
    print(f"\ndense K streams {dense_bytes / 2**20:.0f} MB/apply "
          f"(at {HBM_BPS / 1e12:.2f} TB/s {bound_us:.1f} us)")
    out = {"device": device_name(dev), "cells": E_cells, "ngl": ngl,
           "max_abs_diff": diff, "scale": scale,
           "sumfact_us": per["sumfact"] * 1e6, "dense_us": per["dense"] * 1e6,
           "dense_bytes": dense_bytes, "dense_bound_us": bound_us,
           "nit": [nit_l, nit_s], "rounds": args.rounds}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
