"""Steady lid-driven cavity at Re=100: centerline-profile extraction (port
of the JAX package's exp/cavity_re100.py).

Runs the 2D no-slip cavity (reference src/cases/cavity-2d.yaml semantics:
lid velocity on 'up', all other walls static) to steady state by time
marching, then extracts the classic validation profiles:

    u(y) on the vertical centerline  x = 0.5
    v(x) on the horizontal centerline y = 0.5

and writes them to a JSON artifact with the JAX artifact's keys. The
artifact is rewritten after every checkpoint, so a run cut short leaves
what it reached. tests/test_torch_cavity_re100.py holds the committed
artifact (cavity_re100_h100.json, beside this file) against Ghia, Ghia &
Shin (1982) and against the JAX package's exp/cavity_re100_fine.json.

    python -m pynama_tpu_torch.exp.cavity_re100 [nelem] [ngl] [t_end] [out]
        [--device cuda] [--dtype float32] [--cg-rtol R]
        [--checkpoints T [T ...]]

Defaults: 50 3 80.0, float32 on the card (the artifact's configuration),
CG rtol 1e-8 below t_end 20 and 1e-6 from there, checkpoints 10, 20, then
every 20 from 30, and t_end (the JAX driver's). More checkpoints leave a
snapshot at each, so a run stopped by a time limit keeps the last one
(each segment restarts the step controller from its small dt0, as at every
checkpoint). --device cpu runs the plain versions, --device cuda without a
card raises.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from pynama_tpu_torch.cases.problem import host_array
from pynama_tpu_torch.exp import card_record, device_of, write_json

#: reference-production parity (src/cases/cavity-2d.yaml): rho=0.5,
#: mu=0.01, lid velocity 2 -> Re = rho*U*L/mu = 100. Resolution matters
#: for the long steady march: the collocation (pointwise) convective term
#: the scheme inherits from the reference (computeVtensV) has no
#: dealiasing, and marginally resolved meshes (cell Reynolds U*h/nu >~ 6)
#: develop a slow aliasing instability; the reference's own production
#: mesh is 50x50 ngl=3, cell Re = 2.
U_LID = 2.0
RHO = 0.5
MU = 0.01

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "cavity_re100_h100.json")


def cavity_cfg(ne, ngl, t_end, max_steps=100000):
    zero = [0, 0]
    return {
        "name": "cavity-re100",
        "material-properties": {"rho": RHO, "mu": MU},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": [ne, ne], "lower": zero, "upper": [1, 1]}},
        "time-solver": {"start-time": 0.0, "end-time": float(t_end),
                        "max-steps": max_steps},
        "boundary-conditions": {"no-slip": {
            "up": [U_LID, 0], "down": zero, "left": zero, "right": zero}},
        "initial-conditions": {"vorticity": [0]},
    }


def march_segments(p, checkpoints, steady_tol=5e-5, on_snapshot=None):
    """March in segments ending at the checkpoints (post_step=None keeps
    the hot loop on the device: a per-step post_step fetches the fields to
    the host every accepted step, which dominates small 2D runs). Returns
    (t, total_steps, steady_at, snapshots) where snapshots[t] = centerline
    profiles taken at the segment boundaries. `on_snapshot(t, total_steps,
    steady_at, snapshots)`, when given, is called after each one."""
    total = 0
    steady_at = None
    prev = None
    snaps = {}
    t = p.start_time
    for t_end in checkpoints:
        p.start_time, p.end_time = float(t), float(t_end)
        try:
            # loose RK tolerances: this is a steady-state relaxation path,
            # not a time-accurate transient, and tight (1e-5) tolerances in
            # f32 reach the CG noise floor as the flow settles and collapse
            # dt to underflow
            t, steps = p.start_solver(rtol=3e-4, atol=3e-4)
        except RuntimeError as e:
            print(f"  segment [{t}, {t_end}] aborted: {e}", flush=True)
            break
        total += steps
        w = host_array(p.vort)
        if prev is not None and t > prev[0]:
            rate = np.abs(w - prev[1]).max() / (t - prev[0])
            rel = rate / max(np.abs(w).max(), 1e-30)
            print(f"  t={t:.2f} ({total} steps) steady-rate {rel:.2e}",
                  flush=True)
            if rel < steady_tol and steady_at is None:
                steady_at = t
        prev = (t, w)
        # a profile snapshot at every checkpoint: the omega max-norm rate
        # is dominated by the singular lid corners; profile drift between
        # checkpoints is the physically meaningful steadiness signal
        snaps[round(float(t), 6)] = centerline_profiles(p)
        if on_snapshot is not None:
            on_snapshot(t, total, steady_at, snaps)
        if steady_at is not None and t >= min(checkpoints[-1],
                                              steady_at + 1e-9):
            break
    return t, total, steady_at, snaps


def centerline_profiles(p):
    mesh = p.mesh
    vel = host_array(p.vel)
    nv, _ = mesh.nodes_over_line("x", 0.5)
    nh, _ = mesh.nodes_over_line("y", 0.5)
    return {
        "y": mesh.coords[nv, 1].tolist(),
        "u_centerline": (vel[nv, 0] / U_LID).tolist(),   # normalized by U
        "x": mesh.coords[nh, 0].tolist(),
        "v_centerline": (vel[nh, 1] / U_LID).tolist(),
    }


def summarize(prof):
    """Extrema of the centerline profiles and where they lie."""
    u = np.array(prof["u_centerline"])
    y = np.array(prof["y"])
    v = np.array(prof["v_centerline"])
    x = np.array(prof["x"])
    return {
        "u_min": float(u.min()), "y_at_u_min": float(y[u.argmin()]),
        "u_mid": float(u[np.argmin(np.abs(y - 0.5))]),
        "v_max": float(v.max()), "x_at_v_max": float(x[v.argmax()]),
        "v_min": float(v.min()), "x_at_v_min": float(x[v.argmin()]),
    }


def checkpoints_for(t_end):
    """10, 20, then every 20 from 30, and t_end."""
    cps = sorted({10.0, 20.0} | set(
        np.arange(30.0, t_end + 1e-9, 20.0).tolist()) | {float(t_end)})
    return [c for c in cps if c <= t_end + 1e-9]


def k1_applications(cg_log):
    """Operator applications of a no-slip engine run, from its CG log (one
    (iterations, loop applications) pair per masked solve, two per rhs):
    per rhs Rw, apply_K(vc) and the A0 residual of each stage, the curl
    between the stages, then srt, div_srt and curl (10), plus the CG
    loops'."""
    return 10 * (len(cg_log) // 2) + sum(int(n) for _, n in cg_log)


def parse_args(argv):
    from pynama_tpu_torch.run_case import DTYPES
    ap = argparse.ArgumentParser(prog="pynama_tpu_torch.exp.cavity_re100",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("nelem", nargs="?", type=int, default=50)
    ap.add_argument("ngl", nargs="?", type=int, default=3)
    ap.add_argument("t_end", nargs="?", type=float, default=80.0)
    ap.add_argument("out", nargs="?", default=OUT)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain versions")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--cg-rtol", type=float, default=None,
                    help="CG relative tolerance (default: 1e-8 below "
                    "t_end 20, else 1e-6)")
    ap.add_argument("--checkpoints", type=float, nargs="+", default=None,
                    help="snapshot times (default: checkpoints_for(t_end))")
    args = ap.parse_args(argv)
    args.dtype = DTYPES[args.dtype]
    return args


def main(argv=None):
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.ops.fused import fused_apply

    args = parse_args(argv)
    dev = device_of(args.device)
    ne, ngl, t_end, out = args.nelem, args.ngl, args.t_end, args.out
    cg_rtol = args.cg_rtol or (1e-8 if t_end < 20 else 1e-6)
    checkpoints = sorted(c for c in (args.checkpoints
                                     or checkpoints_for(t_end))
                         if c <= t_end + 1e-9)
    p = Problem(cavity_cfg(ne, ngl, t_end), device=dev, dtype=args.dtype,
                solver="cg", cg_rtol=cg_rtol, cg_maxiter=2000)
    t0 = time.perf_counter()
    p.setUp()
    setup_s = time.perf_counter() - t0
    dtype = str(p.dtype).replace("torch.", "")
    print(f"setup {setup_s:.1f}s: {p.mesh.n_nodes} nodes, dtype {dtype}, "
          f"device {dev}", flush=True)
    config = {"nelem": ne, "ngl": ngl, "t_end": t_end, "dtype": dtype,
              "cg_rtol": cg_rtol, "checkpoints": checkpoints,
              "setup_s": setup_s, **card_record(dev)}
    p.cg_log = []
    fused_apply.launches = 0
    t0 = time.perf_counter()
    written = []

    def write(t, steps, steady_at, snaps):
        wall = time.perf_counter() - t0
        prof = centerline_profiles(p)
        doc = {
            "case": (f"lid-driven cavity Re=100 (rho={RHO}, mu={MU}, "
                     f"U_lid={U_LID}, L=1)"),
            "config": {**config, "t_reached": t, "steps": steps,
                       "steady_at": steady_at, "wall_s": wall,
                       "s_per_step": wall / max(steps, 1),
                       "cg_solves": len(p.cg_log),
                       "cg_iters": sum(int(i) for i, _ in p.cg_log),
                       "k1_launches": fused_apply.launches,
                       "k1_applications": k1_applications(p.cg_log)},
            "summary": summarize(prof),
            "snapshots": {str(k): v for k, v in snaps.items()},
            **prof,
        }
        write_json(out, doc)
        print(f"  checkpoint t={t:.4f}: {steps} steps, {wall:.1f} s, wrote "
              f"{out}", flush=True)
        written.append(doc)
        return doc

    t, steps, steady_at, snaps = march_segments(p, checkpoints,
                                                on_snapshot=write)
    # a run whose first segment aborted has written nothing yet
    doc = written[-1] if written else write(t, steps, steady_at, snaps)
    c = doc["config"]
    print(f"marched to t={t:.2f} in {steps} steps ({c['wall_s']:.1f}s, "
          f"{c['s_per_step']:.4f} s/step); steady at t~{steady_at}; K1 "
          f"{c['k1_launches']} launches, {c['k1_applications']} "
          "applications", flush=True)
    print("summary:", {k: round(v, 5) for k, v in doc["summary"].items()})
    return doc


if __name__ == "__main__":
    main()
