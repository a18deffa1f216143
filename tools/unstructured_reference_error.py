"""The JAX package's own errors on chip_smoke.py's unstructured meshes, on
the CPU.

    python tools/unstructured_reference_error.py [--case hex|quad|both]
        [--hex-t-end T] [--quad-t-end T]

Writes the meshes of `chip_smoke.py`'s `unstructured` phase with its own
writers (bench.py's 10^3 distorted hexes; 50^2 distorted quads by the rule
of tests/msh_fixtures.py) into a temporary directory and runs pynama_tpu's
Problem on them, float64 on the CPU:

  hex   taylor_green3d (the taylor-green3d case file's physics) at ngl=4,
        CG at rtol 1e-6 (maxiter 1000), as the phase's part (b);
  quad  taylor_green (the taylor-green case file's physics) at ngl=3, the
        engine's CG at rtol 1e-12 in place of the direct solve the phase's
        part (c) resolves to (the same discretization; the 20,402^2 dense
        factor stays off the CPU).

Each runs the adaptive stepper from dt0 = 1e-3 at atol = rtol = 1e-4 to
the end time T (default: chip_smoke's HEX_TG3D_REF_T / QUAD_TG_REF_T,
where the phase's 3 float32 steps ended on an NVIDIA H100 80GB HBM3) and
prints one JSON line: the end time, the steps and the relative max-norm
vorticity error against the analytic field there (chip_smoke's
HEX_TG3D_REF_ERR and QUAD_TG_REF_ERR). With T = 0 it takes 3 accepted
steps instead, wherever they end.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from pynama_tpu.cases import Problem  # noqa: E402


def run(name, tmp, t_end):
    c = chip_smoke
    if name == "hex":
        path = c.write_hex_msh(os.path.join(tmp, "hex.msh"), c.HEX_N,
                               c.HEX_N, c.HEX_N, c.MESH_DISTORT)
        cfg = c.gmsh_tg_config(path, "taylor_green3d", 4, c.UNSTRUCT_STEPS)
        opts = dict(solver="cg", cg_rtol=1e-6, cg_maxiter=1000)
    else:
        path = c.write_quad_msh(os.path.join(tmp, "quad.msh"), c.QUAD_N,
                                c.QUAD_N, c.MESH_DISTORT)
        cfg = c.gmsh_tg_config(path, "taylor_green", 3, c.UNSTRUCT_STEPS)
        opts = dict(solver="cg", cg_rtol=1e-12, cg_maxiter=20000)
    if t_end:
        cfg["time-solver"].update({"end-time": t_end, "max-steps": 1000})
    t0 = time.perf_counter()
    p = Problem(cfg, **opts)
    p.setUp()
    t_end, steps = p.start_solver(dt0=1e-3, atol=1e-4, rtol=1e-4)
    w_exact = np.asarray(p.exact_fields(t_end)[1])
    err = float(np.abs(np.asarray(p.vort) - w_exact).max()
                / np.abs(w_exact).max())
    print(json.dumps({"case": name, "config": cfg["name"],
                      "n_nodes": p.mesh.n_nodes, "options": opts,
                      "t_end": t_end, "steps": steps,
                      "vort_rel_max_err": err,
                      "seconds": time.perf_counter() - t0}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="both", choices=["hex", "quad", "both"])
    ap.add_argument("--hex-t-end", type=float,
                    default=chip_smoke.HEX_TG3D_REF_T)
    ap.add_argument("--quad-t-end", type=float,
                    default=chip_smoke.QUAD_TG_REF_T)
    args = ap.parse_args()
    t_end = {"hex": args.hex_t_end, "quad": args.quad_t_end}
    with tempfile.TemporaryDirectory() as tmp:
        for name in (("hex", "quad") if args.case == "both" else
                     (args.case,)):
            run(name, tmp, t_end[name])


if __name__ == "__main__":
    main()
