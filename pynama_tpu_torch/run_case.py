"""CLI driver (reference `src/run_case.py:164-189`), port of
pynama_tpu/run_case.py.

Run modes (the reference's `-test` option, run_case.py:177-184):
    (none)     production run: time-integrate and dump HDF5/XDMF per step
    kle        single KLE solve against exact fields, dump for ParaView
    chart      KLE p-convergence sweep (error vs ngl, loglog chart)
    operators  operator-accuracy sweep (convective/diffusive/curl errors)
    chartkle   KLE error chart for one ngl over viscous times

Usage:
    python -m pynama_tpu_torch.run_case -case cavity [-device cuda]
    python -m pynama_tpu_torch.run_case -case taylor-green -test chart
    python -m pynama_tpu_torch.run_case -case path/to/case.yaml \
        -device cpu -dtype float64

Accepts the reference's single-dash flags; case names resolve against
`pynama_tpu_torch/cases/yaml/` or a filesystem path. The device and dtype
are explicit (`-device`, default cuda; `-dtype`, default float32): asking
for cuda without a card raises, it never runs on the CPU instead. Case
files and the chart dumps need PyYAML; the HDF5 snapshots, checkpoints and
`-resume` need h5py; the chart modes' PNGs need matplotlib.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from pynama_tpu_torch.cases.problem import FUSED_BLOCK_LEFT_OUT
from pynama_tpu_torch.config import device_of

logger = logging.getLogger("pynama_tpu_torch.run_case")

CASE_DIR = os.path.join(os.path.dirname(__file__), "cases", "yaml")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def load_case(name: str) -> dict:
    import yaml
    for cand in (name, f"{name}.yaml",
                 os.path.join(CASE_DIR, f"{name}.yaml"),
                 os.path.join(CASE_DIR, name)):
        if os.path.isfile(cand):
            with open(cand) as f:
                return yaml.safe_load(f)
    raise FileNotFoundError(
        f"case '{name}' not found (searched {CASE_DIR} and cwd)")


def make_problem(cfg: dict, **kw):
    """The case's Problem: a config with `bodies` is an IBM case, moving if
    any body has `vel: dynamic`."""
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.cases.ibm import (ImmersedBoundaryDynamic,
                                            ImmersedBoundaryStatic)
    if "bodies" in cfg:
        dyn = any(b.get("vel") == "dynamic" for b in cfg["bodies"])
        cls = ImmersedBoundaryDynamic if dyn else ImmersedBoundaryStatic
    else:
        cls = Problem
    return cls(cfg, **kw)


def _set_up(cfg: dict, args, **kw):
    """make_problem + setUp, logging which operator route the engine runs
    (the user picks it with -fused and -sumfact; on a gmsh mesh it is
    always the per-element route)."""
    p = make_problem(cfg, **_overrides(args, skip_ngl="ngl" in kw), **kw)
    p.setUp()
    ops = p.engine_ops
    if ops is not None:
        route = ("per-element matrices and the gather DSS (gmsh mesh)"
                 if not ops.lay_v.structured else "fused_apply (-fused on)"
                 if ops.fused else "plain ops/local.py DSS (-fused off)")
        logger.info("engine operator route: %s; K %s", route,
                    "dense" if ops.sumfact is None else "sum-factorized")
    return p


def time_solving(cfg: dict, args):
    """Production run (reference timeSolving, run_case.py:152-162).
    Returns (problem, end time, accepted steps)."""
    from pynama_tpu_torch.utils import Timer
    timer = Timer()
    timer.tic()
    p = _set_up(cfg, args)
    p.setup_viewer()
    if getattr(args, "resume", None):
        from pynama_tpu_torch.io import load_checkpoint
        ck = load_checkpoint(args.resume)
        p.vort = p._field(ck["vorticity"])
        p.vel = p._field(ck["velocity"])
        p.start_time = ck["t"]
        logger.info("resumed from %s at t=%g step=%d", args.resume,
                    ck["t"], ck["step"])
    ts_kw = {}
    for name in ("rtol", "atol", "dt0", "tableau"):
        if getattr(args, name, None) is not None:
            ts_kw[name] = getattr(args, name)
    t, steps = p.run(log_diagnostics=bool(getattr(args, "diag", False)),
                     fast_io=bool(getattr(args, "fast_io", False)), **ts_kw)
    logger.info("Total time: %.3fs (%d steps to t=%g)", timer.toc(), steps, t)
    if getattr(args, "checkpoint", None):
        from pynama_tpu_torch.io import save_checkpoint
        from pynama_tpu_torch.cases.problem import host_array
        save_checkpoint(args.checkpoint, host_array(p.vort),
                        host_array(p.vel), t, 0.0, steps, cfg)
        logger.info("checkpoint written to %s", args.checkpoint)
    return p, t, steps


def generate_chart(cfg: dict, args):
    """KLE p-convergence sweep (reference generateChart,
    run_case.py:31-77): error vs N* for each viscous time."""
    from pynama_tpu_torch.io.plotter import ErrorPlotter
    viscous_times = [0.001, 0.01, 0.1, 1]
    ngls = list(range(3, args.max_ngl + 1))
    errors = {tau: [] for tau in viscous_times}
    for ngl in ngls:
        p = _set_up(cfg, args, ngl=ngl)
        errs = p.kle_errors(viscous_times)
        for tau, e in zip(viscous_times, errs):
            errors[tau].append(e)
        logger.info("ngl=%d errors=%s", ngl, errs)
    name = cfg.get("name", "case")
    ErrorPlotter().plot_convergence(ngls, errors, f"test-kle-{name}.png")
    _dump_yaml(f"out-kle-chart-{name}.yaml",
               {"ngls": ngls,
                "errors": {str(k): [float(x) for x in v]
                           for k, v in errors.items()}})


def generate_chart_operators(cfg: dict, args):
    """Operator convergence sweep (reference generateChartOperators,
    run_case.py:80-131)."""
    from pynama_tpu_torch.io.plotter import Plotter
    ngls = list(range(3, args.max_ngl + 1))
    conv, diff, curl = [], [], []
    for ngl in ngls:
        p = _set_up(cfg, args, ngl=ngl)
        ec, ed, ecu = p.operators_errors()
        conv.append(ec)
        diff.append(ed)
        curl.append(ecu)
        logger.info("ngl=%d conv=%.3e diff=%.3e curl=%.3e", ngl, ec, ed, ecu)
    name = cfg.get("name", "case")
    x = 2 * (np.asarray(ngls) - 1)
    Plotter().plot({"convective": (x, conv), "diffusive": (x, diff),
                    "curl": (x, curl)},
                   f"test-operators-{name}.png", xlabel="N* = 2(ngl-1)",
                   ylabel="weighted L2 error", loglog=True)
    _dump_yaml(f"out-operators-test-{name}.yaml",
               {"ngl": ngls, "convective": [float(x) for x in conv],
                "diffusive": [float(x) for x in diff],
                "curl": [float(x) for x in curl]})


def kle_test_fields(p) -> dict:
    """The KLE test's solve on a set-up Problem: the exact vorticity at the
    start time in, the solved velocity against the exact one out. Returns
    the host fields the test dumps, in its order."""
    from pynama_tpu_torch.cases.problem import host_array
    time = p.start_time
    exact_vel, exact_vort = p.exact_fields(time)
    vort, vel = p.solve_kle(exact_vort, p.vel, time)
    exact_vel, vort, vel = map(host_array, (exact_vel, vort, vel))
    err = exact_vel - vel
    logger.info("KLE |error| = %.3e", np.linalg.norm(err))
    return {"velocity": vel, "vorticity": vort, "error": err,
            "exact_velocity": exact_vel}


def solve_kle_test(cfg: dict, args):
    """Single KLE solve vs exact fields + ParaView dump (reference
    solveKLETests, base_problem.py:266-287). Returns (problem, fields)."""
    p = _set_up(cfg, args)
    p.setup_viewer()
    fields = kle_test_fields(p)
    p.viewer.save_data(0, p.start_time, **fields)
    p.viewer.write_xmf(p.case_name)
    return p, fields


def generate_chart_kle(cfg: dict, args):
    """KLE error over viscous times at the case ngl (reference
    generateChartKLE, run_case.py:139-149)."""
    p = _set_up(cfg, args)
    taus = [0.001, 0.01, 0.1, 0.5, 1]
    errs = p.kle_errors(taus)
    for tau, e in zip(taus, errs):
        logger.info("tau=%g -> |err| %.3e", tau, e)
    _dump_yaml(f"out-kle-{cfg.get('name', 'case')}.yaml",
               {"tau": taus, "error": [float(e) for e in errs]})


def _dump_yaml(path, data):
    import yaml
    with open(path, "w") as f:
        yaml.dump(data, f)
    logger.info("wrote %s", path)


def _overrides(args, skip_ngl=False):
    """Problem kwargs from CLI args; robust to partially-populated
    Namespace objects (programmatic callers): the device defaults to cuda
    and the dtype to float32, as on the command line."""
    get = lambda name: getattr(args, name, None)
    kw = {"device": device_of(get("device") or "cuda", "-device"),
          "dtype": DTYPES[get("dtype") or "float32"]}
    if get("ngl") and not skip_ngl:
        kw["ngl"] = args.ngl
    if get("nelem"):
        kw["nelem"] = args.nelem
    if get("solver"):
        kw["solver"] = args.solver
    # solver tuning (the reference forwards any -ksp_* flag into
    # KSP.setFromOptions, kle_solver.py:62)
    if get("cg_rtol") is not None:
        kw["cg_rtol"] = args.cg_rtol
    if get("cg_atol") is not None:
        kw["cg_atol"] = args.cg_atol
    if get("maxiter") is not None:
        kw["cg_maxiter"] = args.maxiter
    if get("pc") is not None:
        kw["pc"] = args.pc
    if get("ndev"):
        kw["ndev"] = args.ndev
    # engine toggles (Options-DB parity: every solver knob CLI-reachable)
    if get("fused") is not None:
        kw["fused"] = {"on": True, "off": False}[args.fused]
    if get("sumfact") is not None:
        kw["sumfact"] = {"on": True, "off": False}[args.sumfact]
    return kw


MODES = {
    None: time_solving,
    "kle": solve_kle_test,
    "chart": generate_chart,
    "operators": generate_chart_operators,
    "chartkle": generate_chart_kle,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="pynama_tpu_torch.run_case", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    # single-dash long flags, PETSc-Options style (reference run_case.py:9-13)
    ap.add_argument("-case", required=True, help="case name or yaml path")
    ap.add_argument("-test", default=None,
                    choices=["kle", "chart", "operators", "chartkle"])
    ap.add_argument("-log", default="INFO", help="logging level")
    ap.add_argument("-device", default="cuda",
                    help="torch device (default cuda; cuda without a card "
                         "raises)")
    ap.add_argument("-dtype", default="float32", choices=sorted(DTYPES),
                    help="runtime dtype of fields and operators")
    ap.add_argument("-ngl", type=int, default=None)
    ap.add_argument("-nelem", type=int, nargs="+", default=None)
    ap.add_argument("-solver", default=None,
                    choices=["cg", "gmres", "direct", "auto"])
    ap.add_argument("-ndev", type=int, default=None,
                    help="run the transient sharded over N ranks "
                         "(spawned here; in place under torchrun)")
    # KLE (KSP) solver tuning — the reference's -ksp_* passthrough analog
    ap.add_argument("-cg-rtol", dest="cg_rtol", type=float, default=None,
                    help="KLE Krylov relative tolerance")
    ap.add_argument("-cg-atol", dest="cg_atol", type=float, default=None,
                    help="KLE Krylov absolute tolerance")
    ap.add_argument("-maxiter", type=int, default=None,
                    help="KLE Krylov max iterations")
    ap.add_argument("-pc", default=None, choices=["jacobi", "schwarz", "fdm"],
                    help="KLE preconditioner")
    ap.add_argument("-fused", default=None, choices=["on", "off"],
                    help="engine operator applications through the fused "
                         "matmul+DSS CUDA kernel (on, the default) or the "
                         "plain ops/local.py DSS (off)")
    ap.add_argument("-fused-block", dest="fused_block", type=int,
                    default=None, help="not taken: " + FUSED_BLOCK_LEFT_OUT)
    ap.add_argument("-sumfact", default=None, choices=["on", "off"],
                    help="sum-factorized K (default: on for gmsh meshes, "
                         "off for box meshes)")
    # TS tuning — the reference's -ts_* passthrough analog
    ap.add_argument("-rtol", type=float, default=None,
                    help="adaptive-RK relative tolerance")
    ap.add_argument("-atol", type=float, default=None,
                    help="adaptive-RK absolute tolerance")
    ap.add_argument("-dt0", type=float, default=None,
                    help="initial timestep")
    ap.add_argument("-tableau", default=None, choices=["5bs", "5dp"],
                    help="embedded RK pair")
    ap.add_argument("-trace", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace into DIR")
    ap.add_argument("-diag", action="store_true",
                    help="log KE/enstrophy/divergence each saved step")
    ap.add_argument("-fast-io", dest="fast_io", action="store_true",
                    help="save steps via the async binary writer; convert "
                         "to HDF5/XDMF after the run")
    ap.add_argument("-max-ngl", dest="max_ngl", type=int, default=10)
    ap.add_argument("-checkpoint", default=None,
                    help="write final state to this HDF5 file")
    ap.add_argument("-resume", default=None,
                    help="resume from a checkpoint HDF5 file")
    return ap


def main(argv=None):
    """Parse the flags and run the mode; returns what the mode returns."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.fused_block is not None:
        ap.error(FUSED_BLOCK_LEFT_OUT)

    logging.basicConfig(
        level=getattr(logging, args.log.upper(), logging.INFO),
        format="%(levelname)s %(name)s: %(message)s")
    device_of(args.device, "-device")
    cfg = load_case(args.case)

    mode = MODES[args.test]
    if args.trace:
        from pynama_tpu_torch.utils.profiling import device_trace
        with device_trace(args.trace):
            return mode(cfg, args)
    return mode(cfg, args)


if __name__ == "__main__":
    main()
