"""Unstructured gather DSS: the row-gather form against the column-major
trailing-gather form (port of the JAX package's exp/dss_gather_opt.py).

`ops/local.py::dss` on a gmsh mesh is `_dss_gather`: a (n_nodes, kmax)
ROW gather from the (E*nn + 1, c) slot array (c = 3 trailing), a sum over
the fan-in, and a row gather back to the slots. The JAX script tested the
form that gathers along the trailing axis instead:

    x_cm = x.T                      (c, E*nn + 1)
    g    = x_cm[:, inc_kmaj]        (c, kmax*n_nodes)  trailing gather
    s    = g.reshape(c, kmax, n).sum(1)                the fan-in sum
    out  = s[:, cell_nodes_flat].T  trailing gather + transpose back

`dss_cm` is that form in torch; it lives here only (which form the engine
takes would be a performance decision). Both are plain torch, on bench.py's
hex mesh (`exp.write_hex_msh`, distortion 0.12) at ngl=4, float32, a
numpy-seeded (default_rng(0)) standard normal t. They first have to agree:
each output is the same sum of at most kmax slots, reduced in another
order, so they may differ by a few f32 roundings of the largest sum;
the limit is max|diff| <= 1e-5 max|ref|, the repo's f32 kernel limit.
Then both are timed by `exp.interleaved_slopes`.

    python -m pynama_tpu_torch.exp.dss_gather_opt [E1d] [ngl]
        [--n1 100] [--target-s 0.8] [--rounds 6] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from pynama_tpu_torch.exp import (device_name, device_of, interleaved_slopes,
                                  write_hex_msh)
from pynama_tpu_torch.mesh import mesh_from_gmsh
from pynama_tpu_torch.ops import local as L

AGREE_LIMIT = 1e-5


def make_dss_cm(mesh, c: int, device):
    """The column-major trailing-gather DSS of `mesh`'s (E, nn*c) local
    vectors (the pad id E*nn reads a zero slot)."""
    E, nn = mesh.n_cells, mesh.nnode_el
    inc = np.asarray(mesh.incidence)            # (n_nodes, kmax) into E*nn
    n_nodes, kmax = inc.shape
    inc_kmaj = torch.as_tensor(inc.T.reshape(-1).astype(np.int64),
                               device=device)
    cn_flat = torch.as_tensor(np.asarray(mesh.cell_nodes).reshape(-1)
                              .astype(np.int64), device=device)

    def dss_cm(x):
        xf = x.reshape(E * nn, c)
        xf = torch.cat([xf, xf.new_zeros((1, c))])
        x_cm = xf.T                              # (c, E*nn+1)
        g = x_cm[:, inc_kmaj]                    # (c, kmax*n_nodes)
        s = g.reshape(c, kmax, n_nodes).sum(dim=1)
        out = s[:, cn_flat]                      # (c, E*nn)
        return out.T.reshape(E, nn * c)
    return dss_cm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="pynama_tpu_torch.exp.dss_gather_opt",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("E1d", nargs="?", type=int, default=10)
    ap.add_argument("ngl", nargs="?", type=int, default=4)
    ap.add_argument("--n1", type=int, default=100, help="short chain")
    ap.add_argument("--target-s", type=float, default=0.8,
                    help="seconds of the long chain")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    E1d, ngl, c = args.E1d, args.ngl, 3
    with tempfile.TemporaryDirectory() as tmp:
        mesh = mesh_from_gmsh(write_hex_msh(os.path.join(tmp, "hex.msh"),
                                            E1d, E1d, E1d, distort=0.12),
                              ngl)
    lay = L.make_local_layout(mesh, c, device=dev, dtype=torch.float32)
    dss_cm = make_dss_cm(mesh, c, dev)
    rng = np.random.default_rng(0)
    E, nn = mesh.n_cells, mesh.nnode_el
    t = torch.as_tensor(rng.standard_normal((E, nn * c)),
                        dtype=torch.float32, device=dev)

    ref = L.dss(lay, t)
    err = float((ref - dss_cm(t)).abs().max())
    scale = float(ref.abs().max())
    print(f"device {device_name(dev)}; {E} hexes ngl={ngl}; equivalence "
          f"max err: {err:.2e} (scale {scale:.2e})", flush=True)
    if not err <= AGREE_LIMIT * scale:
        raise RuntimeError(f"dss_gather_opt: the two gather DSS forms "
                           f"differ by {err / scale:.3e} > {AGREE_LIMIT}")

    def chain(fn):
        def make(n):
            def run(t_):
                x = t_
                for _ in range(n):
                    y = fn(x)
                    x = y / (1.0 + y.abs().max())
                return x
            return run
        return make

    res = interleaved_slopes(
        [("row_gather", chain(lambda x: L.dss(lay, x)), (t,)),
         ("cm_trailing", chain(dss_cm), (t,))],
        n1=args.n1, target_s=args.target_s, rounds=args.rounds)
    for k, (per, fl) in res.items():
        print(f"{k:14s}: {per*1e6:8.1f} us (floor {fl*1e3:.0f} ms)")
    out = {"device": device_name(dev), "cells": E, "ngl": ngl,
           "kmax": int(np.asarray(mesh.incidence).shape[1]),
           "agree_err": err, "scale": scale,
           "row_gather_us": res["row_gather"][0] * 1e6,
           "cm_trailing_us": res["cm_trailing"][0] * 1e6,
           "rounds": args.rounds}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
