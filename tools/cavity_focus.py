"""A few accepted steps of the Re=100 cavity from t=0, to reckon what a long
march of pynama_tpu_torch/exp/cavity_re100.py costs before it runs.

    python tools/cavity_focus.py [--nelem 50] [--ngl 3] [--steps 50]
        [--dtype float32] [--cg-rtol 1e-6] [--t-end 80] [--device cuda]

The driver's configuration (cavity_cfg, RK tolerances 3e-4, CG maxiter
4000) marched from t=0 at the driver's first dt0 ((t_end - 0) / (10 *
100000)) for --steps accepted steps. Prints one JSON line: the end time,
wall, s/step, rhs evaluations per step (8 per RK attempt), CG iterations
per solve and wall per iteration, the first and last 16 solves' counts,
and K1's launches against the engine's applications. The device is
explicit: cuda without a card raises.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from pynama_tpu_torch.cases import Problem  # noqa: E402
from pynama_tpu_torch.exp import card_record, device_of  # noqa: E402
from pynama_tpu_torch.exp import cavity_re100 as cav  # noqa: E402
from pynama_tpu_torch.ops.fused import fused_apply  # noqa: E402
from pynama_tpu_torch.run_case import DTYPES  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nelem", type=int, default=50)
    ap.add_argument("--ngl", type=int, default=3)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--cg-rtol", type=float, default=1e-6)
    ap.add_argument("--t-end", type=float, default=80.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = device_of(args.device)
    fused_apply.launches = 0
    p = Problem(cav.cavity_cfg(args.nelem, args.ngl, args.t_end,
                               max_steps=args.steps),
                device=dev, dtype=DTYPES[args.dtype], solver="cg",
                cg_rtol=args.cg_rtol, cg_maxiter=4000)
    p.setUp()
    p.cg_log = []
    t0 = time.perf_counter()
    t, n = p.start_solver(dt0=args.t_end / (10 * 100000), rtol=3e-4,
                          atol=3e-4)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    it = [int(i) for i, _ in p.cg_log]
    print(json.dumps({
        "config": vars(args), **card_record(dev), "t": t, "steps": n,
        "wall_s": wall, "s_per_step": wall / n,
        "rhs_per_step": len(it) / 2 / n, "cg_iters": sum(it),
        "iters_per_solve": sum(it) / len(it),
        "us_per_iter": wall / sum(it) * 1e6, "first_iters": it[:16],
        "last_iters": it[-16:], "k1": fused_apply.launches,
        "k1_applications": cav.k1_applications(p.cg_log)}))


if __name__ == "__main__":
    main()
