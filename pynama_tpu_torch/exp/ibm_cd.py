"""IBM static-cylinder drag-coefficient trajectory and resolution
convergence (port of the JAX package's exp/ibm_cd.py).

cd(t) histories at three Eulerian resolutions (35, 50, 70 elements per
axis) for the reference's ibm-static production case (2D cylinder r=0.5 in
a [-3,3]^2 box, uniform Re=10 inflow), with the drag computed from the
virtual flux as the reference's computeDragForce
(src/cases/immersed_boundary.py:115-160; here ibm/bodies.py
compute_force). Writes ibm_cd_h100.json beside this file, with the JAX
artifact's keys (exp/ibm_cd_r05.json) and the device it ran on;
tests/test_torch_ibm_cd.py holds its drag tails against the JAX
package's.

    python -m pynama_tpu_torch.exp.ibm_cd [t_end] [out]
        [--device cuda] [--dtype float32] [--nelem 35 50 70]

--device cpu runs the plain versions; --device cuda without a card raises.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from pynama_tpu_torch.exp import card_record, device_of, write_json

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "ibm_cd_h100.json")
NELEM = (35, 50, 70)
CASE = ("static cylinder r=0.5 in [-3,3]^2, uniform inflow Re=10 "
        "(reference src/cases/ibm-static.yaml). cd_phys = momentum the "
        "correction imparts per unit time / (0.5 rho U^2 D), the "
        "physically normalized drag (its sign is that of the momentum given "
        "TO the fluid, the opposite of the drag on the body, as in the JAX "
        "package); cd_reference_definition = raw flux sum per "
        "computeDragForce (immersed_boundary.py:115-160), a "
        "resolution-scaled trace kept for parity")


def cfg_for(nelem, t_end, max_steps=4000):
    return {
        "name": "ibm-cd",
        "save-n-steps": 10,                      # force_every = 1
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": 3, "box-mesh": {
            "nelem": [nelem, nelem], "lower": [-3, -3], "upper": [3, 3]}},
        "time-solver": {"start-time": 0, "end-time": float(t_end),
                        "max-steps": max_steps},
        "boundary-conditions": {"uniform": {
            "re": 10, "direction": 0, "Lref": "1", "rho": 0.5,
            "mu": 0.01}},
        "initial-conditions": {"vorticity": [0]},
        "bodies": [{"type": "circle", "vel": "static", "radius": 0.5,
                    "center": [0, 0]}],
    }


def tail(times, cd, t):
    """cd over the last 30% of the run (t > 0.7 t_reached), or its last 5
    values when no force step lies there."""
    times, cd = np.asarray(times), np.asarray(cd)
    return cd[times > 0.7 * t] if (times > 0.7 * t).any() else cd[-5:]


def run(nelem, t_end, dev, dtype, cg_rtol=1e-6, cg_maxiter=800):
    """One resolution: setUp, the march to t_end at the RK tolerances
    1e-4, and its record (the JAX artifact's keys, plus wall, s/step and
    K1's launches against the engine's applications)."""
    from pynama_tpu_torch.cases.ibm import ImmersedBoundaryStatic
    from pynama_tpu_torch.ops.fused import fused_apply

    p = ImmersedBoundaryStatic(cfg_for(nelem, t_end), device=dev,
                               dtype=dtype, solver="cg", cg_rtol=cg_rtol,
                               cg_maxiter=cg_maxiter)
    t0 = time.perf_counter()
    p.setUp()
    setup_s = time.perf_counter() - t0
    print(f"nelem={nelem}: setup {setup_s:.1f}s, h={p.h:.4f}, "
          f"{p.body.n_nodes} lag points", flush=True)
    p.cg_log = []
    fused_apply.launches = 0
    t0 = time.perf_counter()
    t, steps = p.start_solver(rtol=1e-4, atol=1e-4)
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    # the sign of cd_phys is the JAX package's, mirrored with its fault:
    # the momentum the correction gives TO the fluid, the opposite of the
    # drag on the body (cases/ibm.py, ROADMAP Queue C)
    cd = np.array(p.history["cd_phys"])
    times = np.array(p.history["times"])
    tl = tail(times, cd, t)
    ref_def = [c[0] for c in p.history["cd"]]
    tl_ref = tail(times, ref_def, t)
    # per solve_kle on the engine: Rw, apply_K(vc) and the A0 residual per
    # stage, the curl between the stages, plus the CG loops' applications;
    # the curl after each correction goes through the global Operators
    n = len(p.cg_log)
    ns = p.engine_ops is not None and p.engine_ops.is_ns
    applications = 0 if p.engine_ops is None else (
        3 * n + (n // 2 if ns else 0) + sum(int(a) for _, a in p.cg_log))
    print(f"  t={t:.2f} steps={steps} wall={wall:.0f}s "
          f"cd_phys_tail={tl.mean():.4f} +- {tl.std():.4f}; K1 "
          f"{fused_apply.launches} launches, {applications} applications",
          flush=True)
    return p, {
        "h": p.h, "lag_points": int(p.body.n_nodes),
        "t_reached": float(t), "steps": int(steps),
        "setup_s": setup_s, "wall_s": wall,
        "s_per_step": wall / max(steps, 1),
        "cg_solves": n, "cg_iters": sum(int(i) for i, _ in p.cg_log),
        "k1_launches": fused_apply.launches,
        "k1_applications": applications,
        "cd_phys_tail_mean": float(tl.mean()),
        "cd_phys_tail_std": float(tl.std()),
        "cd_reference_definition_tail_mean": float(tl_ref.mean()),
        "cd_reference_definition_tail_std": float(tl_ref.std()),
        "times": times.tolist(),
        "cd_phys": cd.tolist(), "cl_phys": list(p.history["cl_phys"]),
        "cd_reference_definition": ref_def,
    }


def parse_args(argv):
    from pynama_tpu_torch.run_case import DTYPES
    ap = argparse.ArgumentParser(prog="pynama_tpu_torch.exp.ibm_cd",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("t_end", nargs="?", type=float, default=30.0)
    ap.add_argument("out", nargs="?", default=OUT)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain versions")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--nelem", type=int, nargs="+", default=list(NELEM),
                    help="elements per axis of each resolution")
    args = ap.parse_args(argv)
    args.dtype = DTYPES[args.dtype]
    return args


def main(argv=None):
    args = parse_args(argv)
    dev = device_of(args.device)
    doc = {"case": CASE,
           "config": {"t_end": args.t_end,
                      "dtype": str(args.dtype).replace("torch.", ""),
                      "solver": "cg", "cg_rtol": 1e-6, "cg_maxiter": 800,
                      "rk_tol": 1e-4, **card_record(dev)},
           "runs": {}}
    for nelem in args.nelem:
        _, doc["runs"][str(nelem)] = run(nelem, args.t_end, dev, args.dtype)
        # rewritten after each resolution: a run cut short keeps the rest
        write_json(args.out, doc)
    print(f"wrote {args.out}", flush=True)
    return doc


if __name__ == "__main__":
    main()
