"""The float32 gap between a sharded step and a single-device step.

    python -m pynama_tpu_torch.exp.sharded_f32_gap [--nelem 6 8]
        [--device cuda|cpu]

On the flagship's physics (the no-slip 3D lid-driven cavity of bench.py:
rho 0.5, mu 0.01, lid [2, 0, 0], ngl=4, float32, CG rtol 1e-6) at each
ne^3 mesh given: two accepted steps from rest on one device (the state the
flagship reaches in chip_smoke.py's main phase), then one step from that
state with dt0 1e-3 twice: on one device, and split into 2 axis-0 slabs on
2 ranks (parallel/sharded_engine.py). The two steps sum the same terms in
different orders (the slab DSS, the psums), so their CG iterates stop at
different points within the rtol; the printed gap, max|a-b| / max|b| of
the vorticity and the velocity, is what that order costs in float32, and
how it grows with the mesh. chip_smoke.py's SHARDED_F32_LIMIT for the
flagship's sharded step is reckoned from it.

One JSON line per mesh. The device is cuda unless --device says otherwise:
cuda without a card raises.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from pynama_tpu_torch.cases import Problem
from pynama_tpu_torch.config import device_of


def flagship_config(ne: int) -> dict:
    zero = [0] * 3
    sides = ("up", "down", "left", "right", "back", "front")
    return {
        "name": "cavity3d", "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": 4, "box-mesh": {
            "nelem": [ne] * 3, "lower": zero, "upper": [1, 1, 1]}},
        "time-solver": {"start-time": 0, "end-time": 1.0, "max-steps": 2},
        "boundary-conditions": {"no-slip": {
            s: ([2, 0, 0] if s == "up" else zero) for s in sides}},
        "initial-conditions": {"vorticity": [0, 0, 0]},
    }


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def run(ne: int, device) -> dict:
    p = Problem(flagship_config(ne), device=device, dtype=torch.float32,
                solver="cg", cg_rtol=1e-6, cg_maxiter=1000)
    p.setUp()
    t_main, _ = p.start_solver(dt0=1e-3)
    state = (p.vort, p.vel)
    out = {}
    for name, ndev in (("single", 1), ("sharded", 2)):
        p.vort, p.vel = state
        p.start_time, p.max_steps = t_main, 1
        p.opts["ndev"] = ndev
        p.cg_log = []
        t0 = time.perf_counter()
        t, steps = p.start_solver(dt0=1e-3)
        out[name] = dict(t=t, steps=steps, vort=p.vort, vel=p.vel,
                         seconds=time.perf_counter() - t0,
                         attempts=len(p.cg_log) // 16)
    a, b = out["sharded"], out["single"]
    return {"nelem": ne, "t_start": t_main, "t": [b["t"], a["t"]],
            "steps": [b["steps"], a["steps"]],
            "attempts": [b["attempts"], a["attempts"]],
            "seconds": [b["seconds"], a["seconds"]],
            "gap_vort": gap(a["vort"], b["vort"]),
            "gap_vel": gap(a["vel"], b["vel"])}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pynama_tpu_torch.exp.sharded_f32_gap",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--nelem", type=int, nargs="+", default=[6, 8])
    ap.add_argument("--device", default="cuda",
                    help="torch device of both runs (cpu: gloo ranks)")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    for ne in args.nelem:
        print(json.dumps(run(ne, device)), flush=True)


if __name__ == "__main__":
    main()
