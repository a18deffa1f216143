"""K1 at the high-order shape, 8^3 ngl=7 (K 1029 -> 1029), against the
unfused route (port of the JAX package's exp/ngl7_blocks.py).

The JAX script swept the Pallas kernel's block size (axis-0 slices per
grid step) at this compute-bound shape beside `jnp_full`, the unfused
`L.dss(L.mm(...))`. A block of axis-0 slices is a Mosaic VMEM tiling
choice that has no meaning on Hopper: K1 takes every shape with its own
tiles (ROADMAP, "Options the port leaves out"), so the sweep is not
ported. What is: K1 (`ops/fused.py::fused_apply`, the CUDA kernel on a
card) against `emm` + `ops/local.py::dss`, on the same numpy-seeded
inputs (t standard normal, matT standard normal / nnc, float32), after a
check that they agree (max|diff| / max|ref| <= 1e-5). Each is timed as
min over interleaved rounds of one `nit`-apply chain
(`y = fn(x); x = y / (1 + max|y|)`, one host read at its end) and
reported in µs and as a share of the card's f32 FFMA peak, 67 TFLOP/s
(H100 SXM data sheet), with the JAX script's FLOP count 2 E nnc^2.

    python -m pynama_tpu_torch.exp.ngl7_blocks [--ne 8] [--ngl 7]
        [--nit 4000] [--rounds 8] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from pynama_tpu_torch import exp as X
from pynama_tpu_torch.ops import fused as F
from pynama_tpu_torch.ops import local as L

AGREE_LIMIT = 1e-5


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="pynama_tpu_torch.exp.ngl7_blocks",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--ne", type=int, default=8)
    ap.add_argument("--ngl", type=int, default=7)
    ap.add_argument("--nit", type=int, default=4000,
                    help="applies per timed chain")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = X.device_of(args.device)
    ne, ngl, ncomp = args.ne, args.ngl, 3
    nelem = (ne, ne, ne)
    t0, matT = X.inputs(ne, ngl, ncomp, dev)
    E, nnc = t0.shape
    lay = L.LocalLayout(perms=L.make_perms(ngl, 3, ncomp, dev),
                        inv_mult=t0.new_zeros((1, 1)), ngl=ngl,
                        nelem=nelem, ncomp=ncomp)
    k1_applies = 0

    def fused(x, m):
        nonlocal k1_applies
        k1_applies += 1
        return F.fused_apply(x, m, nelem, ngl, ncomp)[0]

    variants = {"unfused": lambda x, m: L.dss(lay, L.emm(x, m)),
                "fused": fused}
    ref = variants["unfused"](t0, matT)
    err = float((fused(t0, matT) - ref).abs().max() / ref.abs().max())
    print(f"device: {X.device_name(dev)}; {ne}^3 ngl={ngl} ({nnc}->{nnc}); "
          f"fused vs unfused max|diff|/max|ref| {err:.3e}", flush=True)
    if not err <= AGREE_LIMIT:
        raise RuntimeError(f"ngl7_blocks: K1 and the unfused apply differ "
                           f"by {err:.3e} > {AGREE_LIMIT}")
    best = X.time_variants(variants, t0, matT, args.nit, args.rounds)

    flops = 2.0 * E * nnc * nnc
    print(f"\n=== ngl={ngl} fused vs unfused ===")
    out = {"device": X.device_name(dev), "ne": ne, "ngl": ngl,
           "agree_err": err, "flops": flops, "peak_flops": X.PEAK_F32,
           "nit": args.nit, "rounds": args.rounds}
    for k, v in best.items():
        share = flops / v / X.PEAK_F32
        print(f"{k:9s}: {v*1e6:6.1f} us  (FFMA peak share "
              f"{share*100:.1f}%)")
        out[f"{k}_us"] = v * 1e6
        out[f"{k}_peak_share"] = share
    out["k1_applications"] = k1_applies
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
