"""The Re=100 cavity march through the JAX package and through the port,
both on the CPU in float64: the references the port's card runs are held
to.

    python tools/cavity_re100_reference.py [--part jax|port|both]
        [--nelem 10] [--ngl 4] [--cg-rtol 1e-9] [--checkpoints 1]
        [--out FILE]

The march is exp/cavity_re100.py's no-slip cavity (rho 0.5, mu 0.01, lid
velocity 2), solver "cg" (maxiter 4000), through each package's
`march_segments`, one segment per checkpoint. Defaults: the coarse march
of tests/test_cavity_re100.py (10x10 ngl=4, CG rtol 1e-9).

`jax`: the JAX package's run (exp/cavity_re100.py loaded by path): at each
checkpoint the accepted steps so far and the centerline profiles (u(y) at
x=0.5, v(x) at y=0.5, normalized by the lid velocity), one JSON line each;
`--out` also writes them as {"config", "snapshots"} (a file of the
artifacts' layout). `port`: pynama_tpu_torch.exp.cavity_re100 on the same
config, on the CPU (the plain versions): its steps and profiles and, with
`both`, its gap to the JAX run at each checkpoint (the largest profile
difference relative to the profile's max-norm, and the step counts): two
float64 runs that differ only in the order of their sums.

Used for: chip_smoke.py's CAVITY_REF, CAVITY_PROFILE_LIMIT and
CAVITY_STEP_SLACK (`--part both --checkpoints 1`); the JAX march to t=10
that tests/test_torch_cavity_re100.py holds the card's coarse artifact to
(`--part both --checkpoints 10`); the JAX march at the production mesh
that it holds the card's 50x50 artifact to (`--part jax --nelem 50 --ngl
3 --cg-rtol 1e-6 --checkpoints 0.5 1 ... --out FILE`). Each checkpoint's
line is held against the TPU artifact's snapshot at that time where it has
one (exp/cavity_re100_fine.json; tests/test_cavity_re100.py's measure:
relative L2 after interpolating its profile onto these nodes).

Prints the seconds each part took.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROFILES = (("u_centerline", "y"), ("v_centerline", "x"))


def tpu_gap(prof, doc, t):
    """Relative L2 of each profile against the TPU artifact's snapshot at
    t, interpolated onto these nodes (tests/test_cavity_re100.py); None
    where the artifact has no snapshot at t."""
    snap = {round(float(k), 6): v for k, v in doc["snapshots"].items()}.get(
        round(float(t), 6))
    if snap is None:
        return None
    out = {}
    for key, axis in PROFILES:
        ref = np.interp(prof[axis], snap[axis], snap[key])
        out[key] = float(np.linalg.norm(np.asarray(prof[key]) - ref)
                         / np.linalg.norm(ref))
    return out


def march(mod, p, checkpoints):
    """(t, steps so far, profiles) at each checkpoint, one segment each: the
    segments of one march_segments call over all of them (each call
    starts from p.start_time, which the solver leaves where it was)."""
    total = 0
    for c in checkpoints:
        t, steps, _, _ = mod.march_segments(p, [c])
        p.start_time = t
        total += steps
        yield t, total, mod.centerline_profiles(p)


def jax_problem(args):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from pynama_tpu.cases import Problem

    spec = importlib.util.spec_from_file_location(
        "jax_cavity_re100", os.path.join(ROOT, "exp", "cavity_re100.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    p = Problem(mod.cavity_cfg(args.nelem, args.ngl, args.checkpoints[-1]),
                solver="cg", cg_rtol=args.cg_rtol, cg_maxiter=4000)
    p.setUp()
    return mod, p


def port_problem(args):
    import torch
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.exp import cavity_re100 as mod

    p = Problem(mod.cavity_cfg(args.nelem, args.ngl, args.checkpoints[-1]),
                device="cpu", dtype=torch.float64, solver="cg",
                cg_rtol=args.cg_rtol, cg_maxiter=4000)
    p.setUp()
    return mod, p


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("jax", "port", "both"),
                    default="both")
    ap.add_argument("--nelem", type=int, default=10)
    ap.add_argument("--ngl", type=int, default=4)
    ap.add_argument("--cg-rtol", type=float, default=1e-9)
    ap.add_argument("--checkpoints", type=float, nargs="+", default=[1.0])
    ap.add_argument("--out", default=None,
                    help="write the JAX run's snapshots here")
    args = ap.parse_args()
    with open(os.path.join(ROOT, "exp", "cavity_re100_fine.json")) as f:
        tpu = json.load(f)
    config = {"nelem": args.nelem, "ngl": args.ngl, "dtype": "float64",
              "cg_rtol": args.cg_rtol, "checkpoints": args.checkpoints}
    runs = {}
    if args.part in ("jax", "both"):
        t0 = time.perf_counter()
        snaps = runs["jax"] = {}
        for t, steps, prof in march(*jax_problem(args), args.checkpoints):
            snaps[round(t, 6)] = dict(prof, steps=steps)
            print(json.dumps({"part": "jax", "t": t, "steps": steps,
                              "tpu_gap": tpu_gap(prof, tpu, t), **prof}),
                  flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump({"config": config, "snapshots": {
                        str(k): v for k, v in snaps.items()}}, f)
        print(f"jax: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.part in ("port", "both"):
        t0 = time.perf_counter()
        mod, p = port_problem(args)
        p.cg_log = []
        for t, steps, prof in march(mod, p, args.checkpoints):
            row = {"part": "port", "t": t, "steps": steps,
                   "cg_solves": len(p.cg_log),
                   "cg_iters": sum(int(i) for i, _ in p.cg_log),
                   "tpu_gap": tpu_gap(prof, tpu, t)}
            ref = runs.get("jax", {}).get(round(t, 6))
            if ref is not None:
                row["jax_steps"] = ref["steps"]
                row["gap_to_jax"] = {
                    key: float(np.abs(np.asarray(prof[key])
                                      - np.asarray(ref[key])).max()
                               / np.abs(ref[key]).max())
                    for key, _ in PROFILES}
            print(json.dumps({**row, **prof}), flush=True)
        print(f"port: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
