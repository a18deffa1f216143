"""The JAX package's IBM histories and body residuals at chip_smoke.py's
`ibm` configurations, and the port's own float32-vs-float64 gap, on the
CPU.

    python tools/ibm_reference.py [--part ref|gap|both] [--case NAME]
        [--nelem N N [N]]

`ref`: each IBM case file of `chip_smoke.IBM_CASES` at its own mesh, cut
to IBM_STEPS accepted steps (`chip_smoke.ibm_config`) from the uncut
file's dt0, through pynama_tpu's run_case.make_problem in float64 at the
adaptive stepper's defaults (atol = rtol = 1e-4) and the engine's CG at
rtol 1e-12 (ibm-static's "auto" resolves to the direct solve; the CG
stands in for it here, keeping its 20,402^2 dense float64 factor off the
CPU). Prints, per case, the step history (the accepted times and the
controller's dt after each step), the force histories (cd, cl, cd_phys,
cl_phys) and max|H v - v_body| after the last correction (the tables at
the body's last position): chip_smoke's IBM_REF, whose dt history the
phase replays (`chip_smoke.ibm_replay`) so both sides take the same steps.

`gap`: the port (pynama_tpu_torch) on the same case files cut to smaller
meshes (IBM_GAP_NELEM, several per case: the gap grows with the mesh),
float64 (CG rtol 1e-12) adaptive, then float32
(CG rtol 1e-6, maxiter 1000, as on the card) replaying the float64 run's
steps: the largest difference of each force history relative to its
force's scale (`chip_smoke.force_gaps`) and the float32 body residual.
chip_smoke's IBM_FORCE_LIMIT and IBM_BODY_RES_LIMIT are set from these.

Prints one JSON line per case and part, then the seconds it took (the
ref part 137 s, the gap part 77 s, each in one process on the CPU).
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
import chip_smoke  # noqa: E402

#: the cut meshes of the float32-vs-float64 gap: those of
#: tests/test_case_library.py's IBM cases, and finer ones to show how the
#: gap grows with the mesh
IBM_GAP_NELEM = {"ibm-static": [(12, 12), (25, 25)],
                 "ibm-dynamic": [(16, 16), (32, 32), (64, 64)],
                 "ibm-sphere": [(8, 6, 6), (12, 9, 9)]}
#: the solver each case file's "auto" resolves to at its own size, which
#: the gap runs take at the cut one
IBM_SOLVER = {"ibm-static": "direct", "ibm-dynamic": "cg",
              "ibm-sphere": "cg"}
HISTORIES = ("cd", "cl", "cd_phys", "cl_phys")


def reference(name, dt0):
    from pynama_tpu import run_case as jrc
    from pynama_tpu.ibm import interpolation as I

    cfg = chip_smoke.ibm_config(jrc, name)
    p = jrc.make_problem(cfg, solver="cg", cg_rtol=1e-12, cg_maxiter=20000)
    p.setUp()
    t, steps = p.start_solver(dt0=dt0)
    xy = getattr(p, "_xy", None)
    if xy is None:
        nodes, w = p.nodes_tab, p.w_tab
    else:
        nodes, w = I.support_tables(p.ibm_ops, xy)
    res = np.asarray(I.interp_H(p.ibm_ops, nodes, w, np.asarray(p.vel))) \
        - p.body.velocities()
    h = p.history
    return {"case": name, "part": "ref", "dt0": dt0, "steps": steps,
            "t_end": t, "n_nodes": p.mesh.n_nodes,
            "lag_points": p.body.n_nodes, "times": h["times"],
            "dt": h["dt"],
            **{k: chip_smoke._flat(h[k]) for k in HISTORIES},
            "body_res": float(np.abs(res).max())}


def gap(name, dt0, nelem):
    import torch
    from pynama_tpu_torch import run_case as trc
    from pynama_tpu_torch.cases import ibm as tibm
    from pynama_tpu_torch.ibm import interpolation as I

    torch.set_num_threads(4)
    cfg = chip_smoke.ibm_config(trc, name, nelem)
    out = {}
    for dtype, opts in ((torch.float64, dict(cg_rtol=1e-12,
                                             cg_maxiter=20000)),
                        (torch.float32, dict(cg_rtol=1e-6,
                                             cg_maxiter=1000))):
        p = trc.make_problem(cfg, device="cpu", dtype=dtype,
                             solver=IBM_SOLVER[name], **opts)
        p.setUp()
        if dtype == torch.float64:
            t, steps = p.start_solver(dt0=dt0)
            sched = dict(times=p.history["times"], dt=p.history["dt"])
        else:
            with chip_smoke.ibm_replay(tibm, *chip_smoke.ibm_schedule(
                    sched)):
                t, steps = p.start_solver(dt0=dt0)
        xy = getattr(p, "_xy", None)
        nodes, w = (p.nodes_tab, p.w_tab) if xy is None \
            else I.support_tables(p.ibm_ops, xy)
        res = I.interp_H(p.ibm_ops, nodes, w, p.vel) \
            - p._field(p.body.velocities())
        out[dtype] = dict(h={k: chip_smoke._flat(p.history[k])
                             for k in HISTORIES}, t=t, steps=steps,
                          solver=p.solver_method,
                          res=float(res.abs().max()))
    a, b = out[torch.float32], out[torch.float64]
    rel = chip_smoke.force_gaps(a["h"], b["h"])
    return {"case": name, "part": "gap", "nelem": nelem,
            "solver": b["solver"], "steps": [a["steps"], b["steps"]],
            "t_end": [a["t"], b["t"]], "rel_gap": rel,
            "body_res_f32": a["res"], "body_res_f64": b["res"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", default="both", choices=["ref", "gap", "both"])
    ap.add_argument("--case", default=None,
                    choices=[n for n, _ in chip_smoke.IBM_CASES])
    ap.add_argument("--nelem", type=int, nargs="+", default=None,
                    help="the gap part at this mesh only")
    args = ap.parse_args()
    t0 = time.perf_counter()
    for name, dt0 in chip_smoke.IBM_CASES:
        if args.case not in (None, name):
            continue
        if args.part in ("gap", "both"):
            for nelem in ([tuple(args.nelem)] if args.nelem
                          else IBM_GAP_NELEM[name]):
                print(json.dumps(gap(name, dt0, nelem)), flush=True)
        if args.part in ("ref", "both"):
            print(json.dumps(reference(name, dt0)), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
