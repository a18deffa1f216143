"""Fused against unfused K apply at the flagship size (port of the JAX
package's exp/fused_ab.py).

The engine's `apply_K` on the flagship no-slip cavity (24^3 ngl=4,
float32, K 192 -> 192) through K1 (`ops/fused.py::fused_apply`, the
hand-written CUDA kernel on a card) against the same engine with
`fused=False`, the plain `ops/local.py` route (`emm`, then the plane DSS).
The two first have to agree (max|diff| / max|ref| <= 1e-5, the repo's f32
kernel limit); then both are timed by `interleaved_slopes` (round-robin,
the slope between min-over-rounds short and long chains, each chain
`y = apply_K(x); x = y / (1 + max|y|)` ending in one host read).

    python -m pynama_tpu_torch.exp.fused_ab [rounds] [--ne 24] [--ngl 4]
        [--n1 400] [--target-s 1.0] [--device cuda]

Returns (and prints as its last line) µs per apply of each, the speedup,
and K1's applications (every apply with fused=True, the agreement check's
included), which a caller can hold against `fused_apply.launches`.
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import json
import sys

import numpy as np
import torch

from pynama_tpu_torch.cases import Problem
from pynama_tpu_torch.engine import local_engine as E
from pynama_tpu_torch.exp import device_name, device_of, interleaved_slopes
from pynama_tpu_torch.exp.solve_overhead import cavity_config

AGREE_LIMIT = 1e-5


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="pynama_tpu_torch.exp.fused_ab",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("rounds", nargs="?", type=int, default=8)
    ap.add_argument("--ne", type=int, default=24)
    ap.add_argument("--ngl", type=int, default=4)
    ap.add_argument("--n1", type=int, default=400, help="short chain")
    ap.add_argument("--target-s", type=float, default=1.0,
                    help="seconds of the long chain")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    p = Problem(cavity_config(args.ne, args.ngl), device=dev,
                dtype=torch.float32, solver="cg", cg_rtol=1e-6,
                cg_maxiter=1000)
    p.setUp()
    ops = p.engine_ops
    ops_nf = dc.replace(ops, fused=False)
    rng = np.random.default_rng(0)
    v = p.to_local(rng.standard_normal((p.mesh.n_nodes, p.dim)))
    fused_applies = 0

    def apply(o, x):
        nonlocal fused_applies
        fused_applies += o.fused
        return E.apply_K(o, x)

    ya, yb = apply(ops, v), apply(ops_nf, v)
    err = float((ya - yb).abs().max() / yb.abs().max())
    print(f"device: {device_name(dev)}; {args.ne}^3 ngl={args.ngl}; fused "
          f"vs unfused max|diff|/max|ref| {err:.3e}", flush=True)
    if not err <= AGREE_LIMIT:
        raise RuntimeError(f"fused_ab: fused and unfused K applies differ "
                           f"by {err:.3e} > {AGREE_LIMIT}")

    def k_chain(nit):
        def run(o, x):
            for _ in range(nit):
                y = apply(o, x)
                x = y / (1.0 + y.abs().max())
            return x
        return run

    res = interleaved_slopes(
        [("fused", k_chain, (ops, v)), ("unfused", k_chain, (ops_nf, v))],
        n1=args.n1, target_s=args.target_s, rounds=args.rounds)
    tf, tu = res["fused"][0], res["unfused"][0]
    print(f"fused {tf*1e6:.1f} us, unfused {tu*1e6:.1f} us, "
          f"speedup {tu/tf:.3f}x (floor {res['fused'][1]*1e3:.0f} ms)")
    out = {"device": device_name(dev), "ne": args.ne, "ngl": args.ngl,
           "agree_err": err, "fused_us": tf * 1e6, "unfused_us": tu * 1e6,
           "speedup": tu / tf, "rounds": args.rounds,
           "k1_applications": fused_applies}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
