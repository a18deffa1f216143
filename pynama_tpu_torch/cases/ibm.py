"""Immersed-boundary flow cases (direct forcing).

Port of pynama_tpu/cases/ibm.py (reference `src/cases/immersed_boundary.py`):

  ImmersedBoundaryStatic  — fixed body; interpolation tables, the normal
                            core C and its Cholesky factor built once
                            (`immersed_boundary.py:19-55, 181-207`)
  ImmersedBoundaryDynamic — prescribed body motion; tables rebuilt on the
                            device every step and C z = r solved matrix-free
                            by CG (`immersed_boundary.py:286-385`)

Per accepted time step (startSolver loop, `immersed_boundary.py:56-113`):
    1. one adaptive-RK step of the vorticity transport (global Problem.rhs)
    2. KLE solve (BCs + velocity from vorticity)
    3. velocity correction: solve C z = -(H v - v_body); v += S z
    4. vorticity <- curl(v); continue from the corrected state
Drag/lift histories from the virtual flux go to <case>.yaml
(`immersed_boundary.py:325-348`).

The fields stay on the device through the whole loop: the RK stages go
through `Problem.rhs`, whose engine route converts between the layouts with
device gathers, and only the force history's few scalars come to the host.

With `ndev=N` (N > 1) the loop runs sharded (`_start_solver_sharded_ibm`,
`ibm/sharded.py`): the RK step, the KLE solve, the correction and the curl
run on N ranks' slabs of the element-local engine (spawned, or a process
group's ranks in place), and rank 0 sends each accepted step's flux (on
force steps) and fields (when saved or a post_step is attached) to the
caller, which keeps the force history.
"""
from __future__ import annotations

import logging
import time as _time

import numpy as np
import torch

from pynama_tpu_torch.cases.problem import Problem, host_array
from pynama_tpu_torch.ibm import interpolation as I
from pynama_tpu_torch.ibm.bodies import BodiesContainer
from pynama_tpu_torch.solver.timestep import AdaptiveStepper
from pynama_tpu_torch.utils import Timer

logger = logging.getLogger("pynama_tpu_torch.ibm")


class ImmersedBoundaryStatic(Problem):
    def setUp(self):
        super().setUp()
        phases = self.setup_phases
        t0 = _time.perf_counter()
        # gmsh meshes may declare h-min explicitly (reference
        # immersed_boundary.py:40: nodeSeparation = h-min / (ngl-1))
        hmin = self.config.get("domain", {}).get("h-min")
        self.h = (float(hmin) / (self.ngl - 1) if hmin is not None
                  else self.mesh.node_separation())
        self.U_ref = self._free_stream_velocity()
        self.body = BodiesContainer(self.config["bodies"], dim=self.dim)
        self.body.create_bodies(self.h)
        self.body.set_vel_ref(self.U_ref)
        logger.info("Node separation: %g, body nodes: %d", self.h,
                    self.body.n_nodes)
        self.ibm_ops = I.make_ibm_ops(self.mesh, self.body.dl,
                                      device=self.device, dtype=self.dtype)
        phases["ibm_bodies"] = _time.perf_counter() - t0
        self._build_interpolation()
        logger.info("IBM setup phases: %s",
                    {k: round(v, 3) for k, v in phases.items()
                     if k.startswith("ibm_")})

    def _free_stream_velocity(self) -> float:
        """|u| of the uniform boundary condition (reference
        getFreeStreamVelocity via `boundary_conditions.py:87-114`)."""
        for s in self.bc.sides:
            if s.velocity is not None:
                return float(np.linalg.norm(s.velocity))
        return 1.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _build_interpolation(self):
        """Support tables and the spread plan, the core C and its factor,
        each timed into setup_phases (ibm_tables, ibm_core, ibm_factor)."""
        phases = self.setup_phases
        t0 = _time.perf_counter()
        xy = self._field(self.body.coordinates())
        self.nodes_tab, self.w_tab = I.support_tables(self.ibm_ops, xy)
        self.plan = I.spread_plan(self.nodes_tab)
        self._sync()
        t1 = _time.perf_counter()
        phases["ibm_tables"] = t1 - t0
        # the eq-tensor core is O(L^2 K^{2 dim}) memory: fine in 2D,
        # prohibitive for large 3D K^3 supports, which assemble C = W Wᵀ on
        # the host through sparse/spgemm.py (the JAX package's switch)
        L, K = self.nodes_tab.shape
        if L * L * K * K <= 2 ** 27:
            C = I.normal_core(self.ibm_ops, self.nodes_tab, self.w_tab)
        else:
            C = self._field(I.normal_core_spgemm(
                self.ibm_ops, self.nodes_tab, self.w_tab))
        self.core = C
        self._sync()
        t2 = _time.perf_counter()
        phases["ibm_core"] = t2 - t1
        # factored in the runtime dtype, as the JAX package does
        chol, info = torch.linalg.cholesky_ex(C)
        if int(info) != 0:
            cond = float(np.linalg.cond(host_array(C).astype(np.float64)))
            raise RuntimeError(
                f"IBM normal core C ({L}x{L}, {C.dtype}) is not positive "
                f"definite to its Cholesky factor (info {int(info)}); "
                f"cond(C) in float64 = {cond:.3e}")
        self.chol = chol
        phases["ibm_factor"] = _time.perf_counter() - t2

    # ----------------------------------------------------------- correction
    def velocity_correction(self, vel, t):
        """v += S C^-1 (v_body - H v); returns (vel, virtual_flux)."""
        body_vel = self._field(self.body.velocities())
        vel = self._field(vel)
        corr, flux = I.correction(
            self.ibm_ops, self.nodes_tab, self.w_tab, self.chol, vel,
            body_vel, n_nodes=self.mesh.n_nodes, plan=self.plan)
        return vel + corr, flux

    # -------------------------------------------------------------- running
    def start_solver(self, post_step=None, dt0=None, atol=1e-4, rtol=1e-4,
                     tableau="5bs"):
        ndev = int(self.opts.get("ndev", 1))
        if ndev > 1:
            if self.engine_ops is None:
                raise ValueError("ndev>1 requires the element-local engine "
                                 "(box mesh + iterative solver)")
            return self._start_solver_sharded_ibm(ndev, post_step, dt0, atol,
                                                  rtol, tableau)
        if dt0 is None:
            dt0 = (self.end_time - self.start_time) / (10 * self.max_steps)
        save_every = int(self.config.get("save-n-steps", 10))
        force_every = max(1, save_every // 10)

        stepper = AdaptiveStepper(self.rhs, atol=atol, rtol=rtol,
                                  tableau=tableau)
        stepper.dt = float(dt0)

        # initial condition (computeInitialCondition,
        # immersed_boundary.py:131-141) — through _per_step_correction:
        # the reference's dynamic override updates the body kinematics at
        # t0 there too (immersed_boundary.py:366-368 called from :140)
        t = self.start_time
        vort, vel = self.solve_kle(self.vort, self.vel, t)
        vel, flux = self._per_step_correction(vel, t)
        vort = self.operator.curl(vel)

        hist = {"times": [], "cd": [], "cl": [], "dt": [], "steps": [],
                "elapsedTimes": [], "cd_phys": [], "cl_phys": []}
        timer = Timer()
        step = 0
        while step < self.max_steps and t < self.end_time - 1e-14:
            timer.tic()
            t, vort, vel = stepper.step(t, vort, vel, t_max=self.end_time)
            step += 1
            vort, vel = self.solve_kle(vort, vel, t)
            vel_pre = vel
            vel, flux = self._per_step_correction(vel, t)
            vort = self.operator.curl(vel)
            dt = stepper.dt
            logger.info("Converged: Step %4d | Time %.4e | DT: %.4e",
                        step, t, dt)
            if self.viewer is not None and step % save_every == 0:
                self._save_step(step, t, vort, vel)
            if step % force_every == 0:
                denom = 0.5 * self.U_ref**2
                fx, fy = self.body.compute_force(host_array(flux),
                                                 denom * dt)
                # the JAX package's "physical" coefficients, mirrored with
                # its known fault: this is the momentum the correction
                # gives TO the fluid per unit time, so its sign is the
                # opposite of the drag on the body (ROADMAP, known faults
                # of the reference). The node sums run on the device; two
                # scalars come to the host.
                mom = ((vel - vel_pre) * self.operator.weight).sum(dim=0)
                cphys = host_array(mom) / (dt * denom * self.body.ref_length)
                hist["times"].append(float(t))
                hist["cd"].append(fx)
                hist["cl"].append(fy)
                hist["cd_phys"].append(float(cphys[0]))
                hist["cl_phys"].append(float(cphys[1]))
                hist["dt"].append(float(dt))
                hist["steps"].append(step)
                hist["elapsedTimes"].append(timer.toc())
                if self.viewer is not None:
                    self.viewer.write_yaml(self.case_name, {
                        "dh": self.h, "dl": self.body.dl,
                        "lagPoints": self.body.n_nodes,
                        "eulerNodes": self.mesh.n_nodes * self.dim_w,
                        "ngl": self.ngl, **hist})
            if post_step is not None:
                post_step(step, t, dt, vort, vel)
        self.vort, self.vel = vort, vel
        self.history = hist
        return t, step

    def _per_step_correction(self, vel, t):
        return self.velocity_correction(vel, t)

    # ------------------------------------------------------ sharded running
    def _start_solver_sharded_ibm(self, ndev, post_step=None, dt0=None,
                                  atol=1e-4, rtol=1e-4, tableau="5bs"):
        """Domain-decomposed IBM transient (`-ndev N`): the RK step, KLE
        solve, velocity correction and curl run on N ranks
        (`job_ibm_transient`); the caller gets each accepted step's flux and,
        when it saves or has a post_step, its gathered fields, and keeps the
        force history as the JAX package's sharded loop does (its cd_phys
        spreads the flux through the tables of the body at t0)."""
        from pynama_tpu_torch.parallel.sharded_engine import run_sharded

        if dt0 is None:
            dt0 = (self.end_time - self.start_time) / (10 * self.max_steps)
        save_every = int(self.config.get("save-n-steps", 10))
        dyn = self.body.is_moving
        ctx = dict(
            vort=host_array(self.vort), vel=host_array(self.vel),
            t0=self.start_time, t_end=self.end_time,
            max_steps=self.max_steps, dt0=float(dt0), atol=atol, rtol=rtol,
            tableau=tableau, save_every=save_every,
            force_every=max(1, save_every // 10),
            want_fields=post_step is not None,
            save=self.viewer is not None, dynamic=dyn,
            scale=float(self.ibm_ops.dl * self.ibm_ops.h))
        if dyn:
            ops = self.ibm_ops
            ctx.update(body=self.body, axes=[host_array(a) for a in ops.axes],
                       h=float(ops.h), dl=float(ops.dl), kernel=ops.kernel,
                       kside=ops.kside, corr_rtol=self._corr_rtol)
        else:
            ctx.update(nodes_tab=host_array(self.nodes_tab),
                       w_tab=host_array(self.w_tab),
                       chol=host_array(self.chol),
                       body_vel=np.asarray(self.body.velocities()))

        hist = {"times": [], "cd": [], "cl": [], "dt": [], "steps": [],
                "elapsedTimes": [], "cd_phys": [], "cl_phys": []}

        def on_message(msg):
            if msg[0] == "warn":
                logger.warning("%s", msg[1])
                return
            _, step, t, dt, flux, vort, vel, elapsed = msg
            logger.info("Converged: Step %4d | Time %.4e | DT: %.4e",
                        step, t, dt)
            if self.viewer is not None and step % save_every == 0:
                if dyn:
                    self.body.update_parameters(t)
                    self._xy = self._field(self.body.coordinates())
                self._save_step(step, t, vort, vel)
            if flux is not None:
                denom = 0.5 * self.U_ref**2
                fx, fy = self.body.compute_force(flux, denom * dt)
                corr = I.spread_S(self.ibm_ops, self.nodes_tab, self.w_tab,
                                  self._field(flux), self.mesh.n_nodes,
                                  self.plan)
                cphys = host_array((corr * self.operator.weight).sum(
                    dim=0)) / (dt * denom * self.body.ref_length)
                hist["times"].append(float(t))
                hist["cd"].append(fx)
                hist["cl"].append(fy)
                hist["cd_phys"].append(float(cphys[0]))
                hist["cl_phys"].append(float(cphys[1]))
                hist["dt"].append(float(dt))
                hist["steps"].append(step)
                hist["elapsedTimes"].append(elapsed)
                if self.viewer is not None:
                    self.viewer.write_yaml(self.case_name, {
                        "dh": self.h, "dl": self.body.dl,
                        "lagPoints": self.body.n_nodes,
                        "eulerNodes": self.mesh.n_nodes * self.dim_w,
                        "ngl": self.ngl, **hist})
            if post_step is not None:
                post_step(step, t, dt, vort, vel)

        res = run_sharded(
            self, ndev, job_ibm_transient, (ctx,),
            overlap_dss=bool(self.opts.get("overlap_dss", False)),
            on_message=on_message)
        out = res[0]["fields"]
        self.rank_stats = [r["stats"] for r in res]
        self.vort, self.vel = self._field(out["vort"]), self._field(out["vel"])
        if dyn:
            self._flux = self._field(out["flux"])
            self.corr_log = list(out["corr_log"])
        self.history = hist
        return out["t"], out["steps"]

    def _save_step(self, step, t, vort, vel):
        nodes = host_array(self.nodes_tab)
        zone = np.zeros((self.mesh.n_nodes, 1))
        zone[np.unique(nodes)] = 1.0
        aff = np.zeros((self.mesh.n_nodes, 1))
        aff[np.unique(nodes[host_array(self.w_tab) > 0])] = 1.0
        self.viewer.save_data(step, t, vorticity=host_array(vort),
                              velocity=host_array(vel),
                              ibm_zone=zone.ravel(),
                              affected_nodes=aff.ravel())
        self.viewer.write_xmf(self.case_name)

    def run(self, atol=1e-4, rtol=1e-4, dt0=None, tableau="5bs",
            log_diagnostics=False, fast_io=False):
        """Production run: the IBM loop saves its own snapshots and force
        history (log_diagnostics and fast_io are taken and not used, as in
        the JAX package)."""
        return self.start_solver(atol=atol, rtol=rtol, dt0=dt0,
                                 tableau=tableau)


class ImmersedBoundaryDynamic(ImmersedBoundaryStatic):
    """Moving body: per step the support tables are recomputed on the
    device at the body's current position and C z = -(H v - v_body) is
    solved MATRIX-FREE (CG on z -> H(S z), warm-started from the previous
    flux); no normal matrix is formed, where the reference rebuilds its
    PETSc matrices and KSP every step (`immersed_boundary.py:366-385`).

    The inherited public `velocity_correction` (Cholesky on `self.chol`)
    reflects the body at t0; the per-step path is `_per_step_correction`.
    `corr_log` gets (CG iterations, relative residual) per correction;
    `_save_step` refreshes the visualization tables to the current
    position."""

    def setUp(self):
        super().setUp()
        self._flux = torch.zeros((self.body.n_nodes, self.dim),
                                 dtype=self.dtype, device=self.device)
        self._corr_rtol = 1e-12 if self.dtype == torch.float64 else 1e-7
        self._xy = None
        self.corr_log = []

    def _per_step_correction(self, vel, t):
        self.body.update_parameters(t)           # host O(L) kinematics only
        xy = self._field(self.body.coordinates())
        self._xy = xy                             # for _save_step refresh
        body_vel = self._field(self.body.velocities())
        vel = self._field(vel)
        nodes, w = I.support_tables(self.ibm_ops, xy)
        corr, flux, (iters, relres) = I.correction_cg(
            self.ibm_ops, nodes, w, vel, body_vel, self._flux,
            n_nodes=self.mesh.n_nodes, rtol=self._corr_rtol)
        self._flux = flux
        iters, relres = int(iters), float(relres)
        self.corr_log.append((iters, relres))
        if relres > 10 * self._corr_rtol:
            logger.warning(
                "IBM correction CG stalled: %d iters, relres %.2e "
                "(rigid-body constraint under-enforced at t=%g)",
                iters, relres, t)
        return vel + corr, flux

    def _save_step(self, step, t, vort, vel):
        """Refresh the support tables to the CURRENT body position before
        writing ibm_zone/affected_nodes (the per-step path never keeps
        them; without this the markers would stay frozen at t0)."""
        if self._xy is not None:
            self.nodes_tab, self.w_tab = I.support_tables(self.ibm_ops,
                                                          self._xy)
            self.plan = I.spread_plan(self.nodes_tab)
        super()._save_step(step, t, vort, vel)


def job_ibm_transient(se, ctx: dict) -> dict:
    """One rank's sharded IBM loop (see `_start_solver_sharded_ibm`). Every
    rank runs the same host loop on psum'd scalars; each accepted step
    posts ("step", step, t, dt, flux or None, vort or None, vel or None,
    seconds) and a stalled moving-body correction ("warn", text). Fields t,
    steps, vort, vel, flux and corr_log at the end."""
    from pynama_tpu_torch.engine import local_engine as E
    from pynama_tpu_torch.ibm import sharded as IS

    ops, comm = se.ops_s, se.comm
    dev, dt_ = se.device, se.dtype
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dt_, device=dev)
    scale, dyn = ctx["scale"], ctx["dynamic"]
    nloc = ops.lay_v.n_cells * ops.nn          # this rank's slots
    corr_log = []
    if not dyn:
        slots, gw, sw = (a[se.rank] for a in IS.build_ibm_shard_tables(
            se.mesh_cells, ctx["nodes_tab"], ctx["w_tab"], se.ndev))
        slots = torch.as_tensor(slots, device=dev)
        gw, sw, chol = f(gw), f(sw), f(ctx["chol"])
        body_vel = f(ctx["body_vel"])
        plan = I.spread_plan(slots)

        def correct(t, vel):
            return IS.correction_local(slots, gw, sw, chol, scale, vel,
                                       body_vel, comm, plan)
    else:
        body = ctx["body"]
        iops = I.IBMOps(axes=tuple(f(a) for a in ctx["axes"]),
                        h=f(ctx["h"]), dl=f(ctx["dl"]),
                        kernel=ctx["kernel"], kside=ctx["kside"])
        slots_of, counts = IS.build_node_slot_map(se.mesh_cells, se.ndev)
        slots_of = torch.as_tensor(slots_of, device=dev)
        counts = f(counts)
        rtol_c = ctx["corr_rtol"]
        flux_rep = torch.zeros((body.n_nodes, ops.dim), dtype=dt_,
                               device=dev)

        def correct(t, vel):
            nonlocal flux_rep
            body.update_parameters(t)
            nodes, w = I.support_tables(iops, f(body.coordinates()))
            sl, g, s = IS.dynamic_tables_local(slots_of, counts, nodes, w,
                                               nloc, se.rank)
            vel, flux_rep, (iters, relres) = IS.correction_cg_local(
                sl, g, s, scale, vel, f(body.velocities()), flux_rep, comm,
                rtol=rtol_c)
            iters, relres = int(iters), float(relres)
            corr_log.append((iters, relres))
            if relres > 10 * rtol_c:
                comm.post(("warn", f"sharded IBM correction CG stalled: "
                                   f"{iters} iters, relres {relres:.2e} at "
                                   f"t={t:g}"))
            return vel, flux_rep

    def accept(t, vort, vel):
        """KLE solve + velocity correction + curl on this rank's slab."""
        vort, vel = E.solve_kle_local(ops, vort, vel, t, se.cg_log)
        vel, flux = correct(t, vel)
        return E.curl(ops, vel), vel, flux

    stepper = AdaptiveStepper(
        None, tableau=ctx["tableau"], attempt=se.make_attempt(
            ctx["tableau"], ctx["atol"], ctx["rtol"]))
    stepper.dt = ctx["dt0"]
    t = ctx["t0"]
    vort, vel = se.shard_state(ctx["vort"], ctx["vel"])
    vort, vel, flux = accept(t, vort, vel)
    timer = Timer()
    step = 0
    while step < ctx["max_steps"] and t < ctx["t_end"] - 1e-14:
        timer.tic()
        t, vort, vel = stepper.step(t, vort, vel, t_max=ctx["t_end"])
        step += 1
        vort, vel, flux = accept(t, vort, vel)
        dt = stepper.dt
        se.accepted.append((step, t, dt))
        w = v = None
        if ctx["want_fields"] or (ctx["save"]
                                  and step % ctx["save_every"] == 0):
            w = se.gather_state(vort, ops.dim_w)
            v = se.gather_state(vel, ops.dim)
        fl = flux.cpu().numpy() if step % ctx["force_every"] == 0 else None
        comm.post(("step", step, t, dt, fl, w, v, timer.toc()))
    return se.result(t=t, steps=step, vort=se.gather_state(vort, ops.dim_w),
                     vel=se.gather_state(vel, ops.dim),
                     flux=flux.cpu().numpy(), corr_log=corr_log)
