"""Case orchestration: mesh + element matrices + BC + engine + time stepping.

Port of the engine path of pynama_tpu/cases/problem.py: builds everything
from a YAML-style config dict (the reference's schema), runs the KLE solve
and the adaptive transient in the element-local layout.

The device and dtype are explicit: `Problem(config, device=..., dtype=...)`.
State `vort`/`vel` is kept in the global node layout (n_nodes, ncomp) on the
device, as in the JAX package; the transient converts it to the local
layout at its start and back at its end.

Analytic-function (`custom-func`) boundary and initial conditions take
the `functions/` libraries; `exact_fields` evaluates the case's `tests`
library. The preconditioner is the `pc` option ("jacobi" by default, or
"fdm" for cold and one-shot solves).

Left out until their ROADMAP items: the global-layout Operators/KLESolver
with the direct and GMRES solvers and the verification sweeps (item 10),
IO and the CLI (item 11), gmsh meshes (item 12) and sharded runs (item 14).
"""
from __future__ import annotations

import logging
import time as _time

import numpy as np
import torch

from pynama_tpu_torch.basis import make_tensor_basis
from pynama_tpu_torch.bc import BoundaryConditions
from pynama_tpu_torch.config import get_config
from pynama_tpu_torch.elements import compute_kle_matrices, compute_operators
from pynama_tpu_torch.engine.local_engine import (apply_vorticity_bc,
                                                  build_engine, rhs_local,
                                                  rk_error_norm,
                                                  solve_kle_local)
from pynama_tpu_torch.functions import get_function_lib
from pynama_tpu_torch.mesh import BoxMesh
from pynama_tpu_torch.ops import local as L
from pynama_tpu_torch.solver.timestep import adaptive_solve

logger = logging.getLogger("pynama_tpu_torch.problem")


class Problem:
    """A configured flow case (reference BaseProblem), engine path."""

    def __init__(self, config: dict, *, device, dtype=None, **kwargs):
        self.config = config
        self.case_name = config.get("name", "case")
        self.device = torch.device(device)
        self.dtype = get_config().dtype if dtype is None else dtype
        mat = config["material-properties"]
        self.rho = float(mat["rho"])
        self.mu = float(mat["mu"])
        self.nu = self.mu / self.rho
        self.opts = dict(kwargs)
        ts = config.get("time-solver", {})
        self.start_time = float(ts.get("start-time", 0.0))
        self.end_time = float(ts.get("end-time", 1.0))
        self.max_steps = int(ts.get("max-steps", 1000))
        #: set to a list to record (iters, loop_applies) of every KLE solve
        #: the transient runs, in order (per right-hand side: the free-slip
        #: stage, then the main stage); iters stays a device tensor
        self.cg_log = None

    # ------------------------------------------------------------------ setup
    def setUp(self):
        phases = {}
        t0 = _time.perf_counter()

        def _mark(name):
            nonlocal t0
            t1 = _time.perf_counter()
            phases[name] = t1 - t0
            t0 = t1

        dom = dict(self.config["domain"])
        ngl = int(self.opts.get("ngl", dom["ngl"]))
        if "gmsh-file" in dom and "box-mesh" not in dom:
            raise NotImplementedError("gmsh meshes are not ported yet "
                                      "(ROADMAP Queue A item 12)")
        box = dict(dom.get("box-mesh", dom))
        nelem = self.opts.get("nelem", box["nelem"])
        lower = self.opts.get("lower", box.get("lower", [0] * len(nelem)))
        upper = self.opts.get("upper", box.get("upper", [1] * len(nelem)))
        self.mesh = BoxMesh.create(ngl, nelem, lower, upper)
        self.dim = self.mesh.dim
        self.dim_w = self.mesh.dim_w
        self.dim_s = self.mesh.dim_s
        self.ngl = ngl
        self.basis = make_tensor_basis(ngl, self.dim)
        _mark("mesh")

        bc_data = dict(self.config["boundary-conditions"])
        for k in ("freeSlip", "noSlip"):
            if k in self.opts:
                key = "free-slip" if k == "freeSlip" else "no-slip"
                bc_data[key] = self.opts[k]
        self.bc = BoundaryConditions(self.mesh, bc_data)
        _mark("bc")

        self._build_operators()
        _mark("operators")
        self._build_kle_solver()
        _mark("kle_solver")
        self._build_engine()
        _mark("engine")
        self.vort, self.vel = self._initial_conditions()
        _mark("initial_conditions")
        self.setup_phases = phases
        logger.info("setup phases: %s",
                    {k: round(v, 2) for k, v in phases.items()})

    def _build_operators(self):
        """Element matrices of the shared geometry (a box mesh is uniform:
        one exact float64 build serves every element)."""
        corners = self.mesh.cell_corners[0]
        self._em = compute_kle_matrices(self.basis, corners)
        self._eo = compute_operators(self.basis, corners)

    def _build_kle_solver(self):
        """Resolve the linear solver. The port runs the engine's PCG; the
        global-layout direct/GMRES solvers come with ROADMAP item 10."""
        method = self.opts.get("solver", get_config().solver)
        if method != "cg":
            raise NotImplementedError(
                f"solver '{method}' is not ported yet (ROADMAP Queue A "
                "item 10); the port runs solver='cg'")
        self.solver_method = method

    def _build_engine(self):
        """Build the element-local execution engine (the hot path)."""
        cfg = get_config()
        eo = self._eo
        self.engine_ops = build_engine(
            self.mesh, self.bc, em_K=self._em.K, em_Rw=self._em.Rw,
            op_curl=eo.Curl, op_srt=eo.SrT, op_div=eo.DivSrT,
            op_weight=eo.weight, rho=self.rho, mu=self.mu,
            device=self.device, dtype=self.dtype,
            cg_rtol=self.opts.get("cg_rtol", cfg.cg_rtol),
            cg_atol=self.opts.get("cg_atol", cfg.cg_atol),
            cg_maxiter=self.opts.get("cg_maxiter", cfg.cg_maxiter),
            # Jacobi by default: FDM wins cold solves but costs ~2x per
            # iteration, which the warm-started RK stages do not pay back
            # (the JAX package's measurement); request pc="fdm" for cold
            # and one-shot solves
            pc=self.opts.get("pc", "jacobi"))

    # ------------------------------------------------- local layout shuttles
    def to_local(self, x) -> torch.Tensor:
        """(n_nodes, ncomp) global field -> (E, nn*ncomp) local tensor."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return torch.as_tensor(L.to_local(self.mesh, np.asarray(x)),
                               dtype=self.dtype, device=self.device)

    def to_global(self, t, ncomp) -> np.ndarray:
        """(E, nn*ncomp) consistent local field -> (n_nodes, ncomp) numpy."""
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        return L.to_global(self.mesh, t, ncomp)

    def _coords64(self) -> torch.Tensor:
        """Node coordinates on the device in float64 (analytic fields are
        evaluated in float64 and then cast, as the reference does)."""
        return torch.as_tensor(self.mesh.coords, dtype=torch.float64,
                               device=self.device)

    def _initial_conditions(self):
        """Initial fields (reference setUpInitialConditions): constant, or
        an analytic-function library at the start time."""
        n = self.mesh.n_nodes
        kw = dict(dtype=self.dtype, device=self.device)
        vort = torch.zeros((n, self.dim_w), **kw)
        vel = torch.zeros((n, self.dim), **kw)
        ic = self.config.get("initial-conditions", {})
        if "custom-func" in ic:
            lib = get_function_lib(ic["custom-func"]["name"])
            a = lib.alpha(self.nu, self.start_time)
            coords = self._coords64()
            vel = lib.velocity(coords, a).to(self.dtype)
            vort = lib.vorticity(coords, a).to(self.dtype)
        elif "velocity" in ic and "vorticity" not in ic:
            vel = torch.as_tensor(ic["velocity"], **kw).tile((n, 1))
        elif "vorticity" in ic:
            vort = torch.as_tensor(ic["vorticity"], **kw).tile((n, 1))
        return vort, vel

    def exact_fields(self, time, names=("velocity", "vorticity")):
        """Exact analytic fields at `time` from the case's `tests` library
        (generateExactVecs), (n_nodes, c) tensors on the device."""
        lib = get_function_lib(self.config["tests"]["custom-func"]["name"])
        a = lib.alpha(self.nu, time)
        coords = self._coords64()
        out = []
        for name in names:
            fn = getattr(lib, name)
            args = (self.nu,) if name == "diffusive" else ()
            out.append(fn(coords, a, *args).to(self.dtype))
        return out

    # ------------------------------------------------------------------- RHS
    def solve_kle(self, vort, vel, t=None):
        """Apply BCs and run the (two-stage) KLE solve; global in and out."""
        t = self.start_time if t is None else t
        vort_l, vel_l = solve_kle_local(self.engine_ops, self.to_local(vort),
                                        self.to_local(vel), t)
        kw = dict(dtype=self.dtype, device=self.device)
        return (torch.as_tensor(self.to_global(vort_l, self.dim_w), **kw),
                torch.as_tensor(self.to_global(vel_l, self.dim), **kw))

    # ----------------------------------------------------------- time solving
    def start_solver(self, post_step=None, dt0=None, atol=1e-4, rtol=1e-4,
                     tableau="5bs"):
        """Integrate vorticity from start to end time (reference ts.solve).
        Returns (t, accepted_steps)."""
        if dt0 is None:
            dt0 = (self.end_time - self.start_time) / (10 * self.max_steps)
        if int(self.opts.get("ndev", 1)) > 1:
            raise NotImplementedError("sharded runs are not ported yet "
                                      "(ROADMAP Queue A item 14)")
        return self._start_solver_local(post_step, dt0, atol, rtol, tableau)

    def _start_solver_local(self, post_step, dt0, atol, rtol,
                            tableau="5bs"):
        """Adaptive integration entirely in the element-local layout; state
        is converted at the boundaries of the run (and per save when a
        post_step consumer is attached)."""
        ops = self.engine_ops

        def _rhs(t, y, aux):
            return rhs_local(ops, t, y, aux, stats=self.cg_log)

        def _post(step, t, dt, y, aux):
            logger.info("Converged: Step %4d | Time %.4e | dt %.2e",
                        step, t, dt)
            if post_step is not None:
                post_step(step, t, dt, self.to_global(y, self.dim_w),
                          self.to_global(aux, self.dim))

        t, vort_l, vel_l, steps = adaptive_solve(
            _rhs, self.start_time, self.end_time,
            self.to_local(self.vort), self.to_local(self.vel),
            dt0=dt0, max_steps=self.max_steps, atol=atol, rtol=rtol,
            tableau=tableau, post_step=_post,
            accept_fn=lambda t, y: apply_vorticity_bc(ops, y, t),
            err_norm=lambda e: rk_error_norm(ops, e))
        kw = dict(dtype=self.dtype, device=self.device)
        self.vort = torch.as_tensor(self.to_global(vort_l, self.dim_w), **kw)
        self.vel = torch.as_tensor(self.to_global(vel_l, self.dim), **kw)
        return t, steps
