"""The JAX package's own error on the 3D Taylor-Green case, on the CPU.

    python tools/tg3d_reference_error.py [--t-end T]

Runs pynama_tpu's Problem on the case file
pynama_tpu/cases/yaml/taylor-green3d.yaml (25^3 elements, ngl=3, custom-func
boundary and initial conditions), float64 on the CPU, with the settings of
`chip_smoke.py`'s `taylor_green3d` phase: CG at rtol 1e-6 (maxiter 1000), the
adaptive stepper from dt0 = 1e-3 at atol = rtol = 1e-4, to the end time T
(default: chip_smoke.TG3D_REF_T, where that phase's 3 float32 steps ended on
an NVIDIA H100 80GB HBM3). Prints one JSON line: the end time, the accepted
steps and the relative max-norm vorticity error against the analytic field
at that time. `chip_smoke.TG3D_ERR_LIMIT` is twice that error.
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
import yaml  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from pynama_tpu.cases import Problem  # noqa: E402

T_END = 0.013183098548825902


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-end", type=float, default=T_END)
    args = ap.parse_args()
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "pynama_tpu", "cases", "yaml", "taylor-green3d.yaml")
    with open(path) as fh:
        cfg = yaml.safe_load(fh)
    cfg["time-solver"]["end-time"] = args.t_end
    t0 = time.perf_counter()
    p = Problem(cfg, solver="cg", cg_rtol=1e-6, cg_maxiter=1000)
    p.setUp()
    t_end, steps = p.start_solver(dt0=1e-3, atol=1e-4, rtol=1e-4)
    w_exact = np.asarray(p.exact_fields(t_end)[1])
    err = float(np.abs(np.asarray(p.vort) - w_exact).max()
                / np.abs(w_exact).max())
    print(json.dumps({"case": "taylor-green3d 25^3 ngl=3 f64 cpu",
                      "t_end": t_end, "steps": steps,
                      "vort_rel_max_err": err,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
