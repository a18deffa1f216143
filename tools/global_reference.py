"""The JAX package's own diagnostics and operator errors on the 3D
Taylor-Green case file, on the CPU.

    python tools/global_reference.py

Builds pynama_tpu's Problem on pynama_tpu/cases/yaml/taylor-green3d.yaml
(25^3 elements, ngl=3, rho 0.5, mu 0.01), float64 on the CPU, with the
global CG solver and no engine (neither is used: only the operators are),
and prints one JSON line: `diagnostics()` at the initial state (t = 0:
kinetic energy, enstrophy, divergence norm) and `operators_errors(1.0)`
(convective, diffusive, curl). `chip_smoke.py`'s `global_ops` phase holds
the port's values on the GPU against these (TG3D_DIAG_REF,
TG3D_OPS_ERR_REF).
"""
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import yaml  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from pynama_tpu.cases import Problem  # noqa: E402


def main():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "pynama_tpu", "cases", "yaml", "taylor-green3d.yaml")
    with open(path) as fh:
        cfg = yaml.safe_load(fh)
    t0 = time.perf_counter()
    p = Problem(cfg, solver="cg", engine=False)
    p.setUp()
    print(json.dumps({"case": "taylor-green3d 25^3 ngl=3 f64 cpu, t=0",
                      "diagnostics": p.diagnostics(),
                      "operators_errors": list(p.operators_errors(1.0)),
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
