"""Sum-factorized hex apply: roofline and phase decomposition on the device
(port of the JAX package's exp/sumfact_roofline.py).

Three nested prefixes of `ops/sumfact.py::apply_sumfact_k`, timed
interleaved (`exp.interleaved_slopes`):

  P0 the component-major gather and both gradient matmuls (returns their
     sum)
  P1 P0 + the stiffness contraction and its scatter matmul (no penalties)
  P2 the full apply

so that P0, P1 - P0 and P2 - P1 localize the cost: gradient matmuls,
stiffness FMAs + scatter, penalty chain. The geometry is E1d^3 hexes on
[0,1]^3 with interior vertices moved by uniform(-0.12, 0.12) / E1d from
numpy's default_rng(0), and t is standard normal from the same generator;
float32, matmuls in full f32 (config.py pins TF32 off).

Roofline on the H100 (SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s f32
FFMA), reckoned by `roofline()` from the arrays of the run; at E=1000,
ngl=4, dim=3:
  bytes/apply = t (768 KB) + y (768 KB) + Gt (2.30 MB) + Jrt (0.97 MB)
              + wr (0.11 MB) ~= 4.9 MB -> 1.5 us
  FLOPs: 4 matmuls (E dim, nn) @ (nn, dim nq), nq = 64 and 27
              ~= 0.21 GFLOP -> 3.1 us
  => bound ~3.1 us (operations). (The JAX docstring's 5.1 us and 3.2 us
  are the TPU v5e's 819 GB/s and 65.7 TF/s, with the symmetric half of
  Gt.)

    python -m pynama_tpu_torch.exp.sumfact_roofline [E1d] [ngl]
        [--n1 100] [--target-s 1.0] [--rounds 6] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from pynama_tpu_torch.basis.tables import make_tensor_basis
from pynama_tpu_torch.exp import (HBM_BPS, PEAK_F32, device_name,
                                  device_of, interleaved_slopes)
from pynama_tpu_torch.ops import sumfact as SF



def phase0(sf, t):
    E = t.shape[0]
    dim, N = sf.dim, sf.ngl
    nn = N ** dim
    zc = t[:, sf.v2cm].reshape(E * dim, nn)
    gf = zc @ sf.Df_flat
    gr = zc @ sf.Dr_flat
    return gf.sum() + gr.sum()


def phase1(sf, t):
    E = t.shape[0]
    dim, N = sf.dim, sf.ngl
    nn = N ** dim
    nqf = sf.nqf
    zc = t[:, sf.v2cm].reshape(E * dim, nn)
    gf = (zc @ sf.Df_flat).reshape(E, dim, dim, nqf)
    s_p = []
    for p in range(dim):
        acc = None
        for r in range(dim):
            term = sf.Gt[:, r, p, :][:, None, :] * gf[:, :, r, :]
            acc = term if acc is None else acc + term
        s_p.append(acc)
    sf_stack = torch.stack(s_p, dim=2).reshape(E * dim, dim * nqf)
    y = sf_stack @ sf.Df_flat.T
    return y.reshape(E, dim * nn)[:, sf.cm2v]


def distorted_corners(E1d: int, rng) -> np.ndarray:
    """(E1d^3, 8, 3) hex corners on [0,1]^3, interior vertices moved by
    uniform(-0.12, 0.12) / E1d from rng (the JAX script's geometry)."""
    nx = E1d
    xs = np.linspace(0, 1, nx + 1)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    verts = np.stack([X, Y, Z], -1)
    verts += rng.uniform(-0.12 / nx, 0.12 / nx, verts.shape) \
        * (verts > 0).all(-1, keepdims=True) * (verts < 1).all(-1, keepdims=True)
    corners = np.zeros((nx, nx, nx, 8, 3))
    off = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
    for k, (i, j, l) in enumerate(off):
        corners[:, :, :, k] = verts[i:nx + i or None, j:nx + j or None,
                                    l:nx + l or None]
    return corners.reshape(-1, 8, 3)


def inputs(E1d: int, ngl: int, device, dtype):
    """(sf, t): the SumFactK of the distorted E1d^3 hexes and a standard
    normal t (E, 3 ngl^3), both from default_rng(0) in the JAX script's
    order."""
    rng = np.random.default_rng(0)
    corners = distorted_corners(E1d, rng)
    sf = SF.build_sumfact(make_tensor_basis(ngl, 3), corners,
                          device=device, dtype=dtype)
    t = torch.as_tensor(rng.standard_normal((corners.shape[0],
                                             3 * ngl ** 3)),
                        dtype=dtype, device=device)
    return sf, t


def roofline(sf, t) -> dict:
    """The full apply's bytes (t read, y written, the geometry arrays read
    once) and FLOPs (the four shared matmuls), and their times on the
    card."""
    E, nnd = t.shape
    nn = nnd // sf.dim
    eb = t.element_size()
    nbytes = 2 * t.numel() * eb + sum(
        a.numel() * a.element_size() for a in (sf.Gt, sf.Jrt, sf.wr))
    flops = 2 * 2 * E * sf.dim * nn * sf.dim * (sf.nqf + sf.nqr)
    t_bytes, t_ops = nbytes / HBM_BPS * 1e6, flops / PEAK_F32 * 1e6
    return {"bytes": nbytes, "flops": flops, "bytes_us": t_bytes,
            "flops_us": t_ops, "bound_us": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def chain_of(fn):
    """make_chain for interleaved_slopes: n steps of fn, each result (or,
    for a scalar phase, t scaled by it) normalized into the next input."""
    def make(n):
        def run(sf, t):
            x = t
            for _ in range(n):
                y = fn(sf, x)
                x = y.reshape(t.shape) / (1.0 + y.abs().max()) \
                    if y.shape == t.shape else \
                    t * (1.0 / (1.0 + y.sum().abs()))
            return x
        return run
    return make


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="pynama_tpu_torch.exp.sumfact_roofline",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("E1d", nargs="?", type=int, default=10)
    ap.add_argument("ngl", nargs="?", type=int, default=4)
    ap.add_argument("--n1", type=int, default=100, help="short chain")
    ap.add_argument("--target-s", type=float, default=1.0,
                    help="seconds of the long chain")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    sf, t = inputs(args.E1d, args.ngl, dev, torch.float32)
    E = t.shape[0]
    print(f"device {device_name(dev)}, E={E}, ngl={args.ngl}")
    roof = roofline(sf, t)
    print(f"roofline: {roof['bytes'] / 1e6:.2f} MB -> "
          f"{roof['bytes_us']:.2f} us at {HBM_BPS / 1e12:.2f} TB/s; "
          f"{roof['flops'] / 1e9:.3f} GFLOP -> {roof['flops_us']:.2f} us at "
          f"{PEAK_F32 / 1e12:.0f} TFLOP/s; bound {roof['bound_us']:.2f} us "
          f"({roof['bound_by']})")

    specs = [("P0_grad_matmuls", chain_of(phase0), (sf, t)),
             ("P1_plus_stiffness", chain_of(phase1), (sf, t)),
             ("P2_full", chain_of(SF.apply_sumfact_k), (sf, t))]
    res = interleaved_slopes(specs, n1=args.n1, target_s=args.target_s,
                             rounds=args.rounds)
    for k, (per, floor) in res.items():
        print(f"{k:20s}: {per*1e6:8.1f} us  (short-chain floor "
              f"{floor*1e3:.1f} ms)")
    p0 = res["P0_grad_matmuls"][0]
    p1 = res["P1_plus_stiffness"][0]
    p2 = res["P2_full"][0]
    print(f"\ndecomposition: gradient matmuls {p0*1e6:.1f}, "
          f"stiffness FMA+scatter {(p1-p0)*1e6:.1f}, "
          f"penalty chain {(p2-p1)*1e6:.1f} us "
          f"(bound {roof['bound_us']:.2f} us)")
    out = {"device": device_name(dev), "E": E, "ngl": args.ngl,
           "P0_us": p0 * 1e6, "P1_us": p1 * 1e6, "P2_us": p2 * 1e6,
           "stiffness_us": (p1 - p0) * 1e6, "penalty_us": (p2 - p1) * 1e6,
           "roofline": roof, "rounds": args.rounds}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
