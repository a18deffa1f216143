"""What a production run's snapshots cost per step on the card.

    python3 tools/cli_save_cost.py [--rounds R] [--steps S]
        [--device cuda] [--nelem NX NY NZ]

The `cli` phase of chip_smoke.py times the cavity.yaml run through
run_case (fast-io writer attached) against Problem.start_solver() without
a writer, one run each. This script separates the parts in one process,
from one set-up state, in turns: S accepted steps of the case file
(30x10x10 ngl=3, f32, CG rtol 1e-6, maxiter 1000, dt0 1e-3) under

  plain     start_solver(), no post-step consumer
  to_global start_solver() with a post-step that only takes both fields
            to the host (what Problem.run does before it writes)
  fast_io   Problem.run(fast_io=True), no viewer (the route chip_smoke
            takes where h5py is missing)
  cli       plain, on a second Problem built through run_case's own
            setup (`-device cuda` gives torch.device("cuda"))

each round in a rotated order, R rounds, after one warm-up run of `plain`
(the first run in a process is ~3x slower: first launches, allocator
growth). Prints one JSON line per run and a summary line: each variant's
median seconds per step and its quartiles. --device
cpu and a small --nelem rehearse it on the CPU (no timing meaning there).
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from pynama_tpu_torch import run_case  # noqa: E402
from pynama_tpu_torch.cases import Problem  # noqa: E402
from pynama_tpu_torch.cases.problem import host_array  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nelem", type=int, nargs=3, default=None)
    args = ap.parse_args()
    dev = run_case.device_of(args.device, "--device")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = run_case.load_case("cavity")
    cfg["time-solver"]["max-steps"] = args.steps
    if args.nelem:
        cfg["domain"]["box-mesh"]["nelem"] = args.nelem
    dt0 = 1e-3
    os.chdir(tempfile.mkdtemp(prefix="save-cost-"))
    index = torch.device(dev.type, 0) if dev.type == "cuda" else dev
    p = Problem(cfg, device=index, dtype=torch.float32, solver="cg",
                cg_rtol=1e-6, cg_maxiter=1000)
    p.setUp()
    cli_args = run_case.build_parser().parse_args(
        ["-case", "cavity", "-device", args.device, "-solver", "cg",
         "-cg-rtol", "1e-6", "-maxiter", "1000"])
    pc = run_case._set_up(cfg, cli_args)
    state = {id(q): (q.vort.clone(), q.vel.clone()) for q in (p, pc)}

    def to_host(step, t, dt, vort, vel):
        host_array(vort), host_array(vel)

    variants = {
        "plain": (p, lambda: p.start_solver(dt0=dt0)),
        "to_global": (p, lambda: p.start_solver(post_step=to_host,
                                                dt0=dt0)),
        "fast_io": (p, lambda: p.run(fast_io=True, dt0=dt0)),
        "cli": (pc, lambda: pc.start_solver(dt0=dt0)),
    }
    names = list(variants)
    per_step = {k: [] for k in names}
    variants["plain"][1]()                              # warm-up
    for r in range(args.rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for name in order:
            q, fn = variants[name]
            q.vort, q.vel = (x.clone() for x in state[id(q)])
            sync()
            t0 = time.perf_counter()
            t_end, steps = fn()
            sync()
            s = time.perf_counter() - t0
            per_step[name].append(s / steps)
            print(json.dumps({"round": r, "variant": name, "steps": steps,
                              "t_end": t_end, "seconds": s,
                              "s_per_step": s / steps}), flush=True)
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "case": "cavity.yaml 30x10x10 ngl=3 f32 cg_rtol=1e-6",
        "median_s_per_step": {k: float(np.median(v))
                              for k, v in per_step.items()},
        "quartiles_s_per_step": {
            k: [float(q) for q in np.percentile(v, [25, 75])]
            for k, v in per_step.items()},
        "rounds": args.rounds, "steps": args.steps}), flush=True)


if __name__ == "__main__":
    main()
