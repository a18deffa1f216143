"""The warm two-stage KLE solve in units of K applies (port of the JAX
package's exp/solve_overhead.py).

    python -m pynama_tpu_torch.exp.solve_overhead [ne] [ngl] [--device cuda]

On the flagship's no-slip cavity (ne^3 elements, ngl, float32, CG rtol
1e-6) it times a chain of K applies (`apply_K`, each result scaled by
1/(1 + max|y|)) and a chain of warm two-stage solves (`solve_kle_local`
from the curl of a numpy-seeded random velocity, each solve starting from
the previous velocity, nudged), each at two lengths. The time per apply
and per solve is the slope between the two lengths' minimum times over the
rounds (a slope of the minima, not a minimum of per-round slopes, which go
negative when the jitter exceeds the length difference). The ratio is the
solve time in units of applies: how far the CG iteration's work outside the
apply (vector ops, host checks, launches) adds to it.

The JAX version's fori_loop chains are Python loops of the same length
here. On a CUDA device each chain is timed by CUDA events around it; on
the CPU (the plain versions) by the host clock. The device is explicit:
--device cuda without a card raises.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from pynama_tpu_torch.cases import Problem
from pynama_tpu_torch.engine import local_engine as E
from pynama_tpu_torch.exp import device_name, device_of


def cavity_config(ne: int, ngl: int) -> dict:
    zero = [0] * 3
    return {
        "name": "exp", "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": [ne] * 3, "lower": zero, "upper": [1] * 3}},
        "boundary-conditions": {"no-slip": {
            "up": [2, 0, 0], "down": zero, "left": zero, "right": zero,
            "back": zero, "front": zero}},
        "initial-conditions": {"vorticity": [0, 0, 0]},
    }


def timer(dev: torch.device):
    """seconds(fn): fn's time, by CUDA events on a CUDA device, else by the
    host clock; fn's work is finished when it returns."""
    if dev.type == "cuda":
        def seconds(fn):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        return seconds

    def seconds(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    return seconds


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="pynama_tpu_torch.exp.solve_overhead",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("ne", nargs="?", type=int, default=24)
    ap.add_argument("ngl", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain versions")
    ap.add_argument("--applies", type=int, nargs=2, default=[2000, 20000],
                    metavar=("SHORT", "LONG"), help="K-apply chain lengths")
    ap.add_argument("--solves", type=int, nargs=2, default=[2, 20],
                    metavar=("SHORT", "LONG"), help="solve chain lengths")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    p = Problem(cavity_config(args.ne, args.ngl), device=dev,
                dtype=torch.float32, solver="cg", cg_rtol=1e-6,
                cg_maxiter=1000)
    p.setUp()
    ops = p.engine_ops
    rng = np.random.default_rng(0)
    v = p.to_local(rng.standard_normal((p.mesh.n_nodes, p.dim)))
    vort = E.curl(ops, v)
    vel0 = torch.zeros_like(v)
    stats = []

    def k_chain(nit):
        x = v
        for _ in range(nit):
            y = E.apply_K(ops, x)
            x = y / (1.0 + y.abs().max())
        return x

    def solve_chain(nit):
        u = vel0
        stats.clear()
        for i in range(nit):
            _, u2 = E.solve_kle_local(ops, vort, u, 0.0, stats)
            u = u2 * (1.0 - 1e-6) + 1e-7 * i
        return u

    seconds = timer(dev)
    chains = {"ks": (k_chain, args.applies[0]),
              "kl": (k_chain, args.applies[1]),
              "ss": (solve_chain, args.solves[0]),
              "sl": (solve_chain, args.solves[1])}
    for fn, n in chains.values():                  # warm
        seconds(lambda: fn(min(n, 2)))
    mins = {k: np.inf for k in chains}
    for r in range(args.rounds):
        for key, (fn, n) in chains.items():
            mins[key] = min(mins[key], seconds(lambda: fn(n)))
        t_apply = (mins["kl"] - mins["ks"]) / (args.applies[1]
                                               - args.applies[0])
        t_solve = (mins["sl"] - mins["ss"]) / (args.solves[1]
                                               - args.solves[0])
        print(f"round {r}: apply {t_apply * 1e6:.1f} us, warm solve "
              f"{t_solve * 1e3:.2f} ms, ratio "
              f"{t_solve / max(t_apply, 1e-12):.0f}", flush=True)
    # the last solve chain's solves: CG iterations and operator
    # applications per solve (free-slip stage, then main stage)
    iters = [int(it) for it, _ in stats]
    applies = [int(n) for _, n in stats]
    out = {"device": device_name(dev), "ne": args.ne, "ngl": args.ngl,
           "dtype": "float32", "apply_us": t_apply * 1e6,
           "warm_solve_ms": t_solve * 1e3,
           "solve_over_apply": t_solve / t_apply,
           "cg_iters_per_solve": float(np.mean(iters)) * 2,
           "cg_loop_applies_per_solve": float(np.mean(applies)) * 2,
           "chains": {k: n for k, (_, n) in chains.items()},
           "rounds": args.rounds}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
