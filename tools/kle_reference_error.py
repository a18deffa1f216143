"""The JAX package's `-test kle` error on the 3D Taylor-Green case file.

    python tools/kle_reference_error.py [--cg-rtol R ...]

Runs what `python -m pynama_tpu.run_case -case taylor-green3d -test kle`
computes (pynama_tpu/run_case.py solve_kle_test, without its HDF5 dump):
the case file pynama_tpu/cases/yaml/taylor-green3d.yaml as it is (25^3
elements, ngl=3, 397,953 velocity dofs; "auto" resolves to CG), float64 on
the CPU, one KLE solve of the exact vorticity at the start time, and the
2-norm of the exact velocity minus the solved one. Prints one JSON line per
CG rtol given (default: 1e-12, the package's default, and 1e-6, the rtol
of `chip_smoke.py`'s `cli` phase). `chip_smoke.KLE_REF_ERR` is the first.
"""
import argparse
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from pynama_tpu import run_case  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cg-rtol", type=float, nargs="+",
                    default=[1e-12, 1e-6])
    args = ap.parse_args()
    cfg = run_case.load_case("taylor-green3d")
    for rtol in args.cg_rtol:
        t0 = time.perf_counter()
        p = run_case.make_problem(cfg, cg_rtol=rtol, cg_maxiter=2000)
        p.setUp()
        t = p.start_time
        exact_vel, exact_vort = p.exact_fields(t)
        _, vel = p.solve_kle(exact_vort, p.vel, t)
        err = np.asarray(exact_vel) - np.asarray(vel)
        print(json.dumps({
            "case": "taylor-green3d 25^3 ngl=3 f64 cpu, -test kle",
            "solver": p.solver_method, "cg_rtol": rtol,
            "velocity_dofs": int(p.mesh.n_nodes * p.dim),
            "kle_error": float(np.linalg.norm(err)),
            "exact_velocity_norm": float(np.linalg.norm(
                np.asarray(exact_vel))),
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
