"""Case orchestration: mesh + operators + BC + KLE solver + time stepping.

Port of pynama_tpu/cases/problem.py: builds everything from a YAML-style
config dict (the reference's schema), exposes the RHS evaluation, the KLE
verification sweeps (`kle_errors`), the operator convergence tests
(`operators_errors`) and the physics monitors (`diagnostics`).

Two layouts, as in the JAX package. The element-local engine runs every
iterative solve (solver "cg" or "gmres") and its transient. The global
layout runs the dense direct solve, the global CG/GMRES when the engine is
switched off (`engine=False`), `Problem.operator` (`Operators`) and the
verification sweeps. `solver="auto"` (the default) takes the direct solve
at or below `direct_max_dofs` velocity dofs and CG above, the reference's
rule.

The device and dtype are explicit: `Problem(config, device=..., dtype=...)`.
State `vort`/`vel` is kept in the global node layout (n_nodes, ncomp) on the
device, as in the JAX package; the transient converts it to the local
layout at its start and back at its end.

Analytic-function (`custom-func`) boundary and initial conditions take
the `functions/` libraries; `exact_fields` evaluates the case's `tests`
library. The preconditioner is the `pc` option ("jacobi" by default, or
"fdm" for cold and one-shot solves).

`setup_viewer` and `run` write the HDF5/XDMF snapshots (or, with
`fast_io`, the async binary ones) of a production run; fields leave the
device as numpy arrays on their way to `io/`. The CLI is `run_case.py`.

The mesh is a box (`box-mesh`) or a gmsh file (`gmsh-file`: 2D quads or
3D hexes, `mesh.mesh_from_gmsh`). On a gmsh mesh every element has its own
matrices (built in the runtime dtype), the engine runs them through the
gather DSS and sum-factorizes K by default (`sumfact=`, which a box mesh
takes too when asked), and the global layout takes the per-element
matrices as they are.

IBM bodies are the subclasses in `cases/ibm.py` (`run_case.make_problem`
picks them for a config with `bodies`).

`ndev=N` (N > 1) runs the transient sharded over N ranks
(`parallel/sharded_engine.py`): in a plain process `start_solver` spawns N
ranks and stores the gathered fields they send back; on the ranks of a
process group of N that is already up (`parallel/multihost.py`) it runs in
place on every rank. `overlap_dss=True` overlaps the plain box DSS's plane
exchange with its bulk passes. `fused_block=` is refused, as the CLI
refuses `-fused-block`: the port's kernel takes every shape.
"""
from __future__ import annotations

import dataclasses
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
from pynama_tpu_torch.mesh import BoxMesh, mesh_from_gmsh
from pynama_tpu_torch.ops import local as L
from pynama_tpu_torch.ops.apply import (ElementOp, apply_op, fanin_sum_np,
                                        make_element_op)
from pynama_tpu_torch.solver.kle import KLESolver, build_system
from pynama_tpu_torch.solver.timestep import adaptive_solve

logger = logging.getLogger("pynama_tpu_torch.problem")

#: the solver names `Problem(solver=...)` takes
SOLVERS = ("auto", "direct", "cg", "gmres")

#: why `Problem(fused_block=N)` raises (the CLI's -fused-block repeats it)
FUSED_BLOCK_LEFT_OUT = (
    "-fused-block is an option the port leaves out (ROADMAP, \"Options the "
    "port leaves out\": the Mosaic block probing of _pick_block/probe_block "
    "has no Hopper meaning; the CUDA kernel takes every shape)")


@dataclasses.dataclass(frozen=True)
class Operators:
    """Row-scaled nodal operators (reference Operators).

    The assembled SrT/DivSrT/Curl are row-scaled by the reciprocal lumped
    weight so applications return nodal field values.
    """
    curl_op: ElementOp     # velocity -> vorticity
    srt_op: ElementOp      # velocity -> strain components
    div_op: ElementOp      # strain -> velocity
    winv: torch.Tensor     # (n_nodes, 1) reciprocal lumped weights
    weight: torch.Tensor   # (n_nodes, 1) lumped weights (for error norms)

    def curl(self, v):
        return apply_op(self.curl_op, v) * self.winv

    def srt(self, v):
        return apply_op(self.srt_op, v) * self.winv

    def div_srt(self, s):
        return apply_op(self.div_op, s) * self.winv


def host_array(x) -> np.ndarray:
    """A field as a host numpy array: a tensor (the global path's state,
    on the device) is copied off its device once; a numpy array (the local
    path's, from to_global) passes through."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compute_vtensv(vel: torch.Tensor, dim: int) -> torch.Tensor:
    """v (x) v packed into the symmetric strain slots (reference
    computeVtensV)."""
    if dim == 2:
        vx, vy = vel[:, 0], vel[:, 1]
        return torch.stack([vx * vx, vx * vy, vy * vy], dim=1)
    vx, vy, vz = vel[:, 0], vel[:, 1], vel[:, 2]
    return torch.stack([vx * vx, vx * vy, vy * vy,
                        vy * vz, vz * vz, vz * vx], dim=1)


class Problem:
    """A configured flow case (reference BaseProblem)."""

    def __init__(self, config: dict, *, device, dtype=None, **kwargs):
        if kwargs.get("fused_block") is not None:
            raise NotImplementedError(FUSED_BLOCK_LEFT_OUT)
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
        #: set to a list to record one pair per iterative KLE solve that
        #: solve_kle, rhs and the transient run, in order (per solve_kle:
        #: the free-slip stage, then the main stage): (iters,
        #: loop_applies) for CG, iters a device tensor; (iters, applies)
        #: for GMRES (solver/kle.py _masked_solve)
        self.cg_log = None
        self.viewer = None

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
            self.mesh = mesh_from_gmsh(dom["gmsh-file"], ngl)
        else:
            box = dict(dom.get("box-mesh", dom))
            nelem = self.opts.get("nelem", box["nelem"])
            lower = self.opts.get("lower",
                                  box.get("lower", [0] * len(nelem)))
            upper = self.opts.get("upper",
                                  box.get("upper", [1] * len(nelem)))
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
        if logger.isEnabledFor(logging.DEBUG):
            from pynama_tpu_torch.utils.report import format_ops_info, \
                ops_info
            logger.debug(format_ops_info(ops_info(self)))

    def _element_op(self, mat, din, dout) -> ElementOp:
        """A global ElementOp of the mesh; every operator shares the index
        tensors `_build_operators` puts on the device."""
        return make_element_op(mat, *self._index_pair, din, dout,
                               self.mesh.n_nodes, device=self.device,
                               dtype=self.dtype)

    def _build_operators(self):
        """Element matrices (a box mesh is uniform: one exact float64 build
        of the shared geometry serves every element; a gmsh mesh gets one
        per element, whose quadratic-form GEMMs run in the runtime dtype,
        as in the JAX package), the global nodal operators and the lumped
        weights."""
        mesh = self.mesh
        idx = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                        device=self.device)
        self._index_pair = (idx(mesh.cell_nodes), idx(mesh.incidence))
        if mesh.is_uniform:
            corners, gdt = mesh.cell_corners[0], None
        else:
            corners = mesh.cell_corners
            gdt = torch.empty((), dtype=self.dtype).numpy().dtype
        self._em = compute_kle_matrices(self.basis, corners, gemm_dtype=gdt)
        eo = compute_operators(self.basis, corners, gemm_dtype=gdt)
        self._eo = eo
        wtile = np.broadcast_to(np.asarray(eo.weight, dtype=np.float64),
                                (mesh.n_cells, mesh.nnode_el))
        w = torch.as_tensor(
            fanin_sum_np(mesh.cell_nodes, wtile, 1, mesh.n_nodes),
            dtype=self.dtype, device=self.device)
        self.operator = Operators(
            curl_op=self._element_op(eo.Curl, self.dim, self.dim_w),
            srt_op=self._element_op(eo.SrT, self.dim, self.dim_s),
            div_op=self._element_op(eo.DivSrT, self.dim_s, self.dim),
            winv=1.0 / w, weight=w)

    def _resolve_solver(self) -> str:
        """The solver the options ask for, "auto" resolved: "direct" at or
        below direct_max_dofs velocity dofs, "cg" above (the reference's
        rule)."""
        cfg = get_config()
        method = self.opts.get("solver", cfg.solver)
        if method not in SOLVERS:
            raise ValueError(f"unknown solver '{method}' (one of {SOLVERS})")
        if method == "auto":
            method = "direct" if self.mesh.n_nodes * self.dim \
                <= cfg.direct_max_dofs else "cg"
        return method

    def _build_kle_solver(self):
        cfg = get_config()
        mesh = self.mesh
        method = self._resolve_solver()
        self.solver_method = method
        n_free = int(self.bc.free_main.sum())
        K_op = self._element_op(self._em.K, self.dim, self.dim)
        Rw_op = self._element_op(self._em.Rw, self.dim_w, self.dim)
        sys_args = dict(K_mat_np=np.asarray(self._em.K),
                        cell_nodes=np.asarray(mesh.cell_nodes),
                        K_op=K_op, method=method,
                        cg_rtol=self.opts.get("cg_rtol", cfg.cg_rtol),
                        cg_atol=self.opts.get("cg_atol", cfg.cg_atol),
                        cg_maxiter=self.opts.get("cg_maxiter",
                                                 cfg.cg_maxiter),
                        device=self.device, dtype=self.dtype)
        main = build_system(free_mask_np=self.bc.free_main, **sys_args)
        fs = build_system(free_mask_np=self.bc.free_fs, **sys_args) \
            if self.bc.needs_fs_stage else None
        self.kle = KLESolver(K_op=K_op, Rw_op=Rw_op, main=main, fs=fs)
        logger.info("KLE solver: %s (%d free dofs / %d nodes)", method,
                    n_free, mesh.n_nodes)

    def _build_engine(self):
        """Build the element-local execution engine (the hot path).

        Used for every iterative (CG, GMRES) solve; the dense-direct method
        keeps the global-layout path (its Cholesky factor lives on the
        global dof vector). Disable explicitly with engine=False."""
        use = self.opts.get("engine",
                            self.solver_method in ("cg", "gmres"))
        self.engine_ops = None
        if not use:
            return
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
            pc=self.opts.get("pc", "jacobi"),
            krylov="gmres" if self.solver_method == "gmres" else "cg",
            fused=self.opts.get("fused", True),
            sumfact=self.opts.get("sumfact"), basis=self.basis)

    # ------------------------------------------------- local layout shuttles
    def to_local(self, x) -> torch.Tensor:
        """(n_nodes, ncomp) global field (numpy or a tensor) -> (E,
        nn*ncomp) local tensor: a gather over cell_nodes on the device
        (the JAX package's traced branch), no host copy of a tensor."""
        x = self._field(x)
        cn = self._index_pair[0]
        return x[cn].reshape(cn.shape[0], -1)

    def to_global(self, t, ncomp) -> np.ndarray:
        """(E, nn*ncomp) consistent local field -> (n_nodes, ncomp) numpy."""
        return L.to_global(self.mesh, host_array(t), ncomp)

    def _to_global_dev(self, t, ncomp) -> torch.Tensor:
        """to_global as a gather of each node's lowest slot (the incidence
        table's first column) on the device. A consistent local field holds
        equal values in every slot of a node, so this equals the host
        route bit for bit."""
        return t.reshape(-1, ncomp)[self._index_pair[1][:, 0]]

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

    def _field(self, x) -> torch.Tensor:
        """A global field as a tensor of the runtime dtype on the device."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------- RHS
    def solve_kle(self, vort, vel, t=None):
        """Apply BCs and run the (possibly two-stage) KLE solve (evalRHS
        pre-solve chain); global fields in and out, on the device."""
        t = self.start_time if t is None else t
        if self.engine_ops is not None:
            vort_l, vel_l = solve_kle_local(
                self.engine_ops, self.to_local(vort), self.to_local(vel),
                t, self.cg_log)
            return (self._to_global_dev(vort_l, self.dim_w),
                    self._to_global_dev(vel_l, self.dim))
        vort = self.bc.apply_vorticity(self._field(vort), t, self.nu)
        vel = self.bc.apply_velocity(self._field(vel), t, self.nu)
        if self.kle.is_ns:
            vel_fs = self.kle.solve_fs(vort, vel, self.cg_log)
            vel_fs = self.bc.apply_tangential(vel_fs, t, self.nu)
            vort = self.operator.curl(vel_fs)
        vel = self.kle.solve(vort, vel, self.cg_log)
        return vort, vel

    def rhs(self, t, vort, vel_prev):
        """d(vort)/dt in the global layout (reference evalRHS), evaluated
        at the stage vector `vort`. Returns (f, vel)."""
        _, vel = self.solve_kle(vort, vel_prev, t)
        vtensv = compute_vtensv(vel, self.dim)
        op = self.operator
        aux1 = 2.0 * self.mu * apply_op(op.srt_op, vel) * op.winv \
            - self.rho * vtensv
        rhs_v = op.div_srt(aux1) / self.rho
        f = op.curl(rhs_v)
        return f, vel

    # ----------------------------------------------------------- time solving
    def start_solver(self, post_step=None, dt0=None, atol=1e-4, rtol=1e-4,
                     tableau="5bs"):
        """Integrate vorticity from start to end time (reference ts.solve):
        in the element-local layout when the engine is built, else in the
        global layout through `rhs`. Returns (t, accepted_steps)."""
        if dt0 is None:
            dt0 = (self.end_time - self.start_time) / (10 * self.max_steps)
        ndev = int(self.opts.get("ndev", 1))
        if ndev > 1:
            if self.engine_ops is None:
                raise ValueError("ndev>1 requires the element-local engine "
                                 "(box mesh + iterative solver)")
            return self._start_solver_sharded(post_step, dt0, atol, rtol,
                                              tableau, ndev)
        if self.engine_ops is not None:
            return self._start_solver_local(post_step, dt0, atol, rtol,
                                            tableau)

        def _post(step, t, dt, y, aux):
            logger.info("Converged: Step %4d | Time %.4e | dt %.2e",
                        step, t, dt)
            if post_step is not None:
                post_step(step, t, dt, y, aux)

        t, vort, vel, steps = adaptive_solve(
            self.rhs, self.start_time, self.end_time,
            self._field(self.vort), self._field(self.vel), dt0=dt0,
            max_steps=self.max_steps, atol=atol, rtol=rtol, tableau=tableau,
            post_step=_post,
            accept_fn=lambda t, w: self.bc.apply_vorticity(w, t, self.nu))
        self.vort, self.vel = vort, vel
        return t, steps

    def _start_solver_sharded(self, post_step, dt0, atol, rtol, tableau,
                              ndev):
        """The transient sharded over `ndev` ranks (spawned here, or this
        process group's ranks in place). The state stays sharded for the
        whole run; fields are gathered per accepted step only when
        post_step is attached, and at the end. Each rank's record (accepted
        steps, CG counts, launches) is kept in `rank_stats`, and rank 0's
        CG log extends `cg_log` when that is a list."""
        from pynama_tpu_torch.parallel.sharded_engine import (job_transient,
                                                              run_sharded)

        def on_message(msg):
            _, step, t, dt, vort, vel = msg
            logger.info("Converged: Step %4d | Time %.4e | dt %.2e",
                        step, t, dt)
            if post_step is not None:
                post_step(step, t, dt, vort, vel)

        res = run_sharded(
            self, ndev, job_transient,
            (host_array(self.vort), host_array(self.vel), self.start_time,
             self.end_time, self.max_steps, dt0, atol, rtol, tableau,
             post_step is not None),
            overlap_dss=bool(self.opts.get("overlap_dss", False)),
            on_message=on_message)
        out = res[0]["fields"]
        self.rank_stats = [r["stats"] for r in res]
        if self.cg_log is not None:
            st = self.rank_stats[0]
            self.cg_log.extend(zip(st["cg_iters"], st["cg_applies"]))
        self.vort, self.vel = self._field(out["vort"]), self._field(out["vel"])
        return out["t"], out["steps"]

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

    # ------------------------------------------------------------------ viewer
    def setup_viewer(self):
        """Configure HDF5/XDMF output (reference Paraviewer.configure +
        saveMesh, base_problem.py:65-71)."""
        from pynama_tpu_torch.io import Paraviewer
        self.viewer = Paraviewer()
        self.viewer.configure(self.dim, self.config.get("save-dir"))
        self.viewer.save_mesh(np.asarray(self.mesh.coords))

    def run(self, atol=1e-4, rtol=1e-4, dt0=None, tableau="5bs",
            log_diagnostics=False, fast_io=False):
        """Production run: integrate + save fields every save-n-steps
        (reference convergedStepFunction, base_problem.py:93-103).

        With fast_io=True the per-step saves go through the native async
        binary writer (the solve loop never blocks on disk) and the
        HDF5/XDMF ParaView layout is produced once at the end by
        converting the binary snapshots. As in the JAX package, the local
        layout's fields are converted to the global layout on every
        accepted step while a writer is attached, saved or not."""
        save_every = int(self.config.get("save-n-steps", 1))
        bin_writer = None
        if fast_io:
            from pynama_tpu_torch.io.binary import BinarySnapshotWriter
            fast_dir = str(self.config.get("save-dir", ".")) + "-fast"
            bin_writer = BinarySnapshotWriter(fast_dir)

        def post(step, t, dt, vort, vel):
            if step % save_every != 0:
                return
            vort, vel = host_array(vort), host_array(vel)
            if bin_writer is not None:
                bin_writer.save(step, t, vorticity=vort, velocity=vel)
            elif self.viewer is not None:
                self.viewer.save_data(step, t, vorticity=vort, velocity=vel)
            if log_diagnostics:
                d = self.diagnostics(vel=vel, vort=vort)
                logger.info("step %d t=%.6g KE=%.6g enstrophy=%.6g "
                            "div_l2=%.3g", step, t, d["kinetic_energy"],
                            d["enstrophy"], d["div_l2"])

        t, steps = self.start_solver(post_step=post, atol=atol, rtol=rtol,
                                     dt0=dt0, tableau=tableau)
        if bin_writer is not None:
            bin_writer.close()
            if self.viewer is not None:
                from pynama_tpu_torch.io.binary import convert_to_paraview
                n = convert_to_paraview(bin_writer.save_dir, self.viewer)
                logger.info("fast-io: converted %d snapshots to HDF5", n)
        if self.viewer is not None:
            self.viewer.write_xmf(self.case_name)
        return t, steps

    # ------------------------------------------------------------ test suite
    def kle_errors(self, viscous_times):
        """Velocity L2 error of the KLE solve against exact fields
        (getKLEError), t = tau^2/(4 nu); each solve warm-starts from the
        previous one's velocity."""
        errors = []
        vel = self.vel
        for tau in viscous_times:
            time = tau**2 / (4 * self.nu)
            exact_vel, exact_vort = self.exact_fields(time)
            _, vel = self.solve_kle(exact_vort, vel, time)
            errors.append(float(torch.linalg.norm(
                (exact_vel - vel).ravel())))
        return errors

    def operators_errors(self, viscous_time=1.0):
        """Weighted-L2 errors of the convective, diffusive and curl
        operators against the exact fields (OperatorsTests)."""
        time = viscous_time**2 / (4 * self.nu)
        exact_vel, exact_vort, exact_conv, exact_diff = self.exact_fields(
            time, ("velocity", "vorticity", "convective", "diffusive"))
        op = self.operator

        vtensv = compute_vtensv(exact_vel, self.dim)
        convective = op.curl(op.div_srt(vtensv))
        aux1 = 2.0 * self.mu * op.srt(exact_vel)
        diffusive = op.curl(op.div_srt(aux1) / self.rho)
        curl = op.curl(exact_vel)

        def werr(err):
            return float(torch.sqrt(((err * err) * op.weight).sum()))

        return (werr(convective - exact_conv), werr(diffusive - exact_diff),
                werr(curl - exact_vort))

    def diagnostics(self, vel=None, vort=None) -> dict:
        """Physics monitors: kinetic energy, enstrophy and the divergence
        norm, weighted quadrature integrals over the domain (numpy arrays
        or tensors in; the current state by default)."""
        vel = self._field(self.vel if vel is None else vel)
        vort = self._field(self.vort if vort is None else vort)
        op = self.operator
        w = op.weight
        ke = 0.5 * self.rho * float(((vel * vel).sum(dim=1, keepdim=True)
                                     * w).sum())
        ens = 0.5 * float(((vort * vort).sum(dim=1, keepdim=True)
                           * w).sum())
        # div(v) = trace of the strain tensor; the diagonal slots of the
        # reduced symmetric packing are [0, 2] (2D) / [0, 2, 4] (3D)
        strain = op.srt(vel)
        diag_slots = [0, 2] if self.dim == 2 else [0, 2, 4]
        div = strain[:, diag_slots].sum(dim=1, keepdim=True)
        div_l2 = float(torch.sqrt(((div * div) * w).sum()))
        return {"kinetic_energy": ke, "enstrophy": ens, "div_l2": div_l2}
