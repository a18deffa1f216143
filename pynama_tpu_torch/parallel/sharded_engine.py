"""Slab-sharded execution of the element-local engine over torch.distributed
ranks.

Port of pynama_tpu/parallel/sharded_engine.py. The JAX package cuts the
element array into N contiguous slabs and runs the same engine code on
every shard under `shard_map` in one process. The port runs one
`torch.distributed` rank per slab, and the same engine code on every rank
with a communicator (`EngineOps.comm`, `parallel/comm.py`) where the JAX
package has `axis_name`: the axis-0 DSS exchanges interface planes with the
neighbour ranks (on a box mesh, K1's raw boundary planes `bnd`), the
gather DSS of an unstructured mesh sums its partition-interface rows over
the ranks, and the CG dots, the RK error norm and the slab FDM's mode grid
are psums.

One rank's EngineOps is the global one with (`split_ops`):
  * every per-element array cut to the rank's rows (elements are e0-major,
    so a box mesh's rows are an axis-0 slab, an unstructured mesh's an
    element range),
  * shared arrays (element matrices, layout perms) as they are,
  * the slab's nelem, and on an unstructured mesh the incidence table in
    the rank's own slot ids and the interface rows `iface`,
  * analytic-function side rows localized to the rank (no padding: that
    only `shard_map` needed),
  * the slab FDM (`solver/fdm.py::shard_fdm`) under pc="fdm" on a box mesh,
    and pc="jacobi" on an unstructured one,
  * the sum-factorized K's per-element geometry cut to the rank's rows.
The JAX package's re-probe of the fused kernel's blocks has no counterpart:
the port's K1 takes every shape.

How ranks start (both routes run the same `ShardedEngine`):
  (i) spawned: `run_sharded` in a plain process splits the engine's numpy
      arrays per rank (`RankSlab`), starts N ranks (`comm.run_ranks`), and
      each rank rebuilds its EngineOps on its device with `ops_from_numpy`
      and runs a job (`job_rhs`, `job_transient`, ...).
      Rank 0 sends the gathered global fields back; during a transient it
      sends each accepted step, with its fields when the caller wants them.
      This is what `Problem(..., ndev=N).start_solver()` does.
  (ii) in place: when a process group of N ranks is already up (`torchrun`
      and `parallel.multihost.initialize()`, the reference's `mpiexec`),
      `run_sharded` builds this rank's ShardedEngine from its own Problem and
      runs the job where it is.

Every rank runs its own copy of the host loops (the adaptive dt controller,
the CG's stopping check); they branch only on psums, which are bitwise equal
on every rank (`SlabComm.psum`), so the ranks stay in lockstep.
`ShardedEngine.rank_stats()` reports each rank's accepted steps and CG
iteration counts, so callers can check that they are the same.
"""
from __future__ import annotations

import dataclasses
import math
import types

import numpy as np
import torch
import torch.distributed as dist

from pynama_tpu_torch.engine import local_engine as E
from pynama_tpu_torch.ops import local as L
from pynama_tpu_torch.ops.fused import dss_pass, fused_apply
from pynama_tpu_torch.parallel.comm import SlabComm, run_ranks
from pynama_tpu_torch.solver.fdm import (shard_fdm, slab_fdm_arrays,
                                         slab_fdm_from_arrays)
from pynama_tpu_torch.solver.timestep import (StepResult, adaptive_loop,
                                              get_tableau, make_step)

#: arrays of ops_from_numpy with one row per element
PER_ELEMENT = tuple(f"lay_{f}.{k}" for f in "vws"
                    for k in ("inv_mult", "cell_nodes")) + (
    "winv_v", "winv_w", "winv_s", "free_main", "free_fs", "diag",
    "mask_vel", "mask_vort", "mask_tang", "const_vel", "const_vort",
    "const_tang", "sumfact.Gt", "sumfact.Jrt", "sumfact.wr")
#: element matrices: shared (2-D) or one per element (3-D)
MATRICES = ("KT", "RwT", "curlT", "srtT", "divT")


def interface_nodes(cell_nodes: np.ndarray, n_nodes: int,
                    ndev: int) -> np.ndarray:
    """Global ids of the nodes touched by the cells of two or more of
    `ndev` contiguous element ranges."""
    cn = np.asarray(cell_nodes)
    E, nn = cn.shape
    so = np.repeat(np.arange(ndev), (E // ndev) * nn)
    smin = np.full(n_nodes, ndev, dtype=np.int64)
    smax = np.full(n_nodes, -1, dtype=np.int64)
    np.minimum.at(smin, cn.ravel(), so)
    np.maximum.at(smax, cn.ravel(), so)
    return np.where(smax > smin)[0]


def split_ops(ops: E.EngineOps, ndev: int, rank: int,
              arrays: dict | None = None) -> tuple:
    """Rank `rank`'s share of `ops` split `ndev` ways, numpy only:
    (arrays, statics, func_sides, fdm) for `ops_from_numpy` (statics are
    its keyword arguments; fdm maps "fdm_main"/"fdm_fs" to a SlabFDM's
    arrays or None). `arrays` is `ops_to_numpy(ops)` when the caller has
    it already."""
    structured = ops.lay_v.structured
    ne0 = ops.nelem[0]
    if ne0 % ndev != 0:
        what = "nelem[0]" if structured else "n_cells"
        raise ValueError(f"{what}={ne0} not divisible by {ndev} devices")
    if not 0 <= rank < ndev:
        raise ValueError(f"rank {rank} of {ndev}")
    local_nelem = (ne0 // ndev,) + tuple(ops.nelem[1:])
    E_loc = math.prod(local_nelem)
    lo, nn = rank * E_loc, ops.nn
    a = E.ops_to_numpy(ops) if arrays is None else arrays
    out = {}
    for key, v in a.items():
        split = key in PER_ELEMENT or (key in MATRICES and v.ndim == 3)
        out[key] = v[lo:lo + E_loc] if split else v
    if not structured:
        # incidence in this rank's slot ids (pad E_loc*nn); the interface
        # rows are the same for the three layouts
        inc = a["lay_v.incidence"]
        mine = (inc >= lo * nn) & (inc < (lo + E_loc) * nn)
        loc = np.where(mine, inc - lo * nn, E_loc * nn)
        iface = interface_nodes(a["lay_v.cell_nodes"], inc.shape[0], ndev)
        for fam in "vws":
            out[f"lay_{fam}.incidence"] = loc
            out[f"lay_{fam}.iface"] = iface
    pc = ops.pc
    fdm = {"fdm_main": None, "fdm_fs": None}
    if pc == "fdm" and structured and ops.fdm_main is not None:
        for k in fdm:
            f = getattr(ops, k)
            fdm[k] = None if f is None else slab_fdm_arrays(
                shard_fdm(f, ndev, rank))
    elif pc == "fdm":
        pc = "jacobi"
    fsides = []
    for fs in ops.func_sides:
        rows = fs.rows.cpu().numpy()
        mine = (rows >= lo * nn) & (rows < (lo + E_loc) * nn)
        fsides.append(E.FuncSide(
            coords=fs.coords.cpu().numpy()[mine], rows=rows[mine] - lo * nn,
            func_name=fs.func_name, kind=fs.kind,
            normal_axis=fs.normal_axis))
    statics = dict(
        ngl=ops.ngl, nelem=local_nelem if structured else (E_loc,),
        dim=ops.dim, dim_w=ops.dim_w, dim_s=ops.dim_s, is_ns=ops.is_ns,
        cg_rtol=ops.cg_rtol, cg_atol=ops.cg_atol, cg_maxiter=ops.cg_maxiter,
        pc=pc, krylov=ops.krylov, fused=ops.fused, structured=structured)
    return out, statics, tuple(fsides), fdm


def _ops_from_parts(parts, *, device, dtype, comm, overlap_dss):
    arrays, statics, fsides, fdm = parts
    fdm = {k: None if v is None else slab_fdm_from_arrays(
        v, device=device, dtype=dtype) for k, v in fdm.items()}
    return E.ops_from_numpy(arrays, **statics, device=device, dtype=dtype,
                            func_sides=fsides, comm=comm,
                            overlap_dss=overlap_dss, **fdm)


def build_sharded_ops(ops: E.EngineOps, ndev: int, rank: int, comm=None,
                      overlap_dss: bool = False) -> E.EngineOps:
    """Rank `rank`'s EngineOps of `ops` split `ndev` ways, on ops' device,
    with `comm` as its communicator (see the module docstring)."""
    return _ops_from_parts(
        split_ops(ops, ndev, rank), device=ops.lay_v.inv_mult.device,
        dtype=ops.lay_v.inv_mult.dtype, comm=comm, overlap_dss=overlap_dss)


@dataclasses.dataclass
class RankSlab:
    """One rank's share of a Problem's engine, numpy only: it crosses to a
    spawned rank by pickling."""
    rank: int
    ndev: int
    parts: tuple             # split_ops's (arrays, statics, func_sides, fdm)
    dtype: torch.dtype
    overlap_dss: bool
    cell_nodes: np.ndarray   # (E, nn) of the whole mesh, for gather_state
    n_nodes: int


def rank_slab(problem, ndev: int, rank: int, overlap_dss: bool = False,
              arrays: dict | None = None) -> RankSlab:
    ops = problem.engine_ops
    if ops is None:
        raise ValueError("ndev>1 requires the element-local engine "
                         "(box mesh + iterative solver)")
    return RankSlab(rank=rank, ndev=ndev,
                    parts=split_ops(ops, ndev, rank, arrays),
                    dtype=problem.dtype, overlap_dss=bool(overlap_dss),
                    cell_nodes=np.asarray(problem.mesh.cell_nodes),
                    n_nodes=int(problem.mesh.n_nodes))


class ShardedEngine:
    """One rank's slab of a Problem's engine and the runtime over it.

    `ShardedEngine(problem, ndev)` on a rank of a process group of ndev
    ranks (route (ii)); `ShardedEngine.from_slab(slab, comm)` on a spawned
    rank (route (i)). State arrays `*_s` are this rank's slab in the local
    layout, on its device. `backend` names the communication: "gloo",
    "nccl", "gloo staged through host" (CUDA ranks sharing a card) or
    "single" (one rank)."""

    def __init__(self, problem, ndev: int, overlap_dss: bool = False,
                 comm: SlabComm | None = None):
        comm = SlabComm(problem.device) if comm is None else comm
        if comm.size != ndev:
            raise ValueError(f"ndev={ndev}, but the process group has "
                             f"{comm.size} ranks")
        self._bind(rank_slab(problem, ndev, comm.rank, overlap_dss), comm)

    @classmethod
    def from_slab(cls, slab: RankSlab, comm: SlabComm) -> "ShardedEngine":
        se = cls.__new__(cls)
        se._bind(slab, comm)
        return se

    def _bind(self, slab: RankSlab, comm: SlabComm):
        self.ndev, self.rank, self.comm = slab.ndev, slab.rank, comm
        self.device, self.dtype = comm.device, slab.dtype
        self.ops_s = _ops_from_parts(slab.parts, device=self.device,
                                     dtype=self.dtype, comm=comm,
                                     overlap_dss=slab.overlap_dss)
        self.backend = ("single" if comm.size == 1 else
                        "gloo staged through host" if comm.staged
                        else comm.backend)
        self.mesh_cells = types.SimpleNamespace(cell_nodes=slab.cell_nodes,
                                                n_nodes=slab.n_nodes)
        E_loc = slab.cell_nodes.shape[0] // self.ndev
        lo = self.rank * E_loc
        self._cn = torch.as_tensor(
            slab.cell_nodes[lo:lo + E_loc].astype(np.int64),
            device=self.device)
        #: (iters, loop applications) of every Krylov solve on this rank
        self.cg_log = []
        #: (step, t, dt) of every accepted step on this rank
        self.accepted = []
        self._launches0 = (fused_apply.launches, dss_pass.launches)
        self._staged0 = comm.staged_bytes

    # ------------------------------------------------------------ state
    def shard_state(self, vort_g, vel_g):
        """Global nodal fields (numpy or tensors) -> this rank's slab of
        the local layout, on its device."""
        def loc(x):
            x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
            return x[self._cn].reshape(self._cn.shape[0], -1)
        return loc(vort_g), loc(vel_g)

    def gather_state(self, t_s, ncomp) -> np.ndarray:
        """Every rank's slab of a consistent local field, gathered into the
        global (n_nodes, ncomp) numpy array (a collective: every rank calls
        it, every rank gets the array)."""
        full = torch.cat(self.comm.all_gather(t_s.contiguous()))
        return L.to_global(self.mesh_cells, full.cpu().numpy(), ncomp)

    # ------------------------------------------------------------ steps
    def rhs(self, t, vort_s, vel_s):
        """rhs_local on this rank's slab: (d vort/dt, vel)."""
        return E.rhs_local(self.ops_s, t, vort_s, vel_s, self.cg_log)

    def make_attempt(self, tableau="5bs", atol=1e-4, rtol=1e-4):
        """The sharded trial step attempt(t, dt, vort_s, vel_s) ->
        StepResult (8 stages x the two-stage KLE solve; the global error
        norm)."""
        ops = self.ops_s

        def rhs(tt, y, aux):
            return E.rhs_local(ops, tt, y, aux, self.cg_log)

        return make_step(rhs, get_tableau(tableau), atol, rtol,
                         err_norm=lambda e: E.rk_error_norm(ops, e))

    def attempt(self, t, dt, vort_s, vel_s, tableau="5bs", atol=1e-4,
                rtol=1e-4) -> StepResult:
        """One adaptive-RK trial step on the slab (8 stages x the
        two-stage KLE solve); the error norm is the global one."""
        return self.make_attempt(tableau, atol, rtol)(t, dt, vort_s, vel_s)

    def accept_bc(self, t, vort_s):
        """Pin the boundary vorticity of an accepted state."""
        return E.apply_vorticity_bc(self.ops_s, vort_s, t)

    def start_solver(self, vort_s, vel_s, t0, t_end, max_steps, dt0=None,
                     atol=1e-4, rtol=1e-4, tableau="5bs", post_step=None):
        """The sharded transient: the host accept/reject dt controller
        (run on every rank, in lockstep) driving the sharded trial step.
        post_step(step, t, dt, vort_s, vel_s) gets this rank's slabs.
        Returns (t, vort_s, vel_s, accepted_steps)."""
        if dt0 is None:
            dt0 = (t_end - t0) / (10 * max_steps)
        tab = get_tableau(tableau)

        def post(step, t, dt, y, aux):
            self.accepted.append((step, t, dt))
            if post_step is not None:
                post_step(step, t, dt, y, aux)

        return adaptive_loop(
            self.make_attempt(tableau, atol, rtol), t0, t_end, vort_s,
            vel_s, dt0=dt0, max_steps=max_steps, order=tab.order,
            accept_fn=self.accept_bc, post_step=post)

    # ---------------------------------------------------------- records
    def rank_stats(self) -> dict:
        """This rank's record: accepted steps, the CG iterations and loop
        applications of each solve, K1's and its DSS pass's launches and
        the staged bytes since this engine was built, peak device
        memory."""
        cuda = self.device.type == "cuda"
        return {
            "rank": self.rank, "backend": self.backend,
            "accepted": list(self.accepted),
            "cg_iters": [int(it) for it, _ in self.cg_log],
            "cg_applies": [int(n) for _, n in self.cg_log],
            "k1_launches": fused_apply.launches - self._launches0[0],
            "dss_pass_launches": dss_pass.launches - self._launches0[1],
            "staged_bytes": self.comm.staged_bytes - self._staged0,
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(self.device)
                               if cuda else None)}

    def result(self, **fields) -> dict:
        """A job's return value: the fields (global numpy arrays, the same
        on every rank) and this rank's record."""
        return {"fields": fields, "stats": self.rank_stats()}


# ------------------------------------------------------------------ jobs
def job_rhs(se: ShardedEngine, t, vort_g, vel_g) -> dict:
    """One sharded rhs of global fields: fields f (d vort/dt) and vel."""
    f_s, v_s = se.rhs(t, *se.shard_state(vort_g, vel_g))
    return se.result(f=se.gather_state(f_s, se.ops_s.dim_w),
                     vel=se.gather_state(v_s, se.ops_s.dim))


def job_rhs_overlap_pair(se: ShardedEngine, t, vort_g, vel_g) -> dict:
    """job_rhs twice on one engine, with overlap_dss off and on: fields
    plain and overlapped, each {"f", "vel"}."""
    out = {}
    for ov in (False, True):
        ops = dataclasses.replace(se.ops_s, overlap_dss=ov)
        f_s, v_s = E.rhs_local(ops, t, *se.shard_state(vort_g, vel_g),
                               se.cg_log)
        out[ov] = {"f": se.gather_state(f_s, ops.dim_w),
                   "vel": se.gather_state(v_s, ops.dim)}
    return se.result(plain=out[False], overlapped=out[True])


def job_transient(se: ShardedEngine, vort_g, vel_g, t0, t_end, max_steps,
                  dt0, atol=1e-4, rtol=1e-4, tableau="5bs",
                  send_fields=False) -> dict:
    """The sharded transient from global fields. Each accepted step posts
    ("step", step, t, dt, vort_g, vel_g) through `se.comm.post`, with the
    gathered fields when `send_fields` (else None). Fields t, steps, vort,
    vel at the end."""
    ops = se.ops_s

    def post(step, t, dt, y, aux):
        w = v = None
        if send_fields:
            w, v = se.gather_state(y, ops.dim_w), se.gather_state(aux, ops.dim)
        se.comm.post(("step", step, t, dt, w, v))

    t, vort_s, vel_s, steps = se.start_solver(
        *se.shard_state(vort_g, vel_g), t0, t_end, max_steps, dt0=dt0,
        atol=atol, rtol=rtol, tableau=tableau, post_step=post)
    return se.result(t=t, steps=steps,
                     vort=se.gather_state(vort_s, ops.dim_w),
                     vel=se.gather_state(vel_s, ops.dim))


def _run_task(comm: SlabComm, slab: RankSlab, fn, args) -> dict:
    """A spawned rank's body: build its engine and run fn(se, *args); the
    fields go back from rank 0 only."""
    res = fn(ShardedEngine.from_slab(slab, comm), *args)
    if comm.rank != 0:
        res = dict(res, fields=None)
    return res


def run_sharded(problem, ndev: int, fn, args=(), *, overlap_dss=False,
                on_message=None) -> list:
    """fn(se, *args) on every rank of problem's engine split ndev ways.

    With a process group already up (route (ii)) it runs here, on this
    rank, and returns [this rank's result]. Otherwise one rank runs here
    when ndev is 1, and ndev > 1 spawned ranks on problem.device's kind
    (route (i)) return every rank's result in rank order, the fields from
    rank 0 only. `on_message` receives what rank 0 posts (every rank's
    posts in route (ii))."""
    if dist.is_available() and dist.is_initialized():
        se = ShardedEngine(problem, ndev, overlap_dss)
        se.comm.on_message = on_message
        return [fn(se, *args)]
    arrays = E.ops_to_numpy(problem.engine_ops) \
        if problem.engine_ops is not None else None
    slabs = [rank_slab(problem, ndev, r, overlap_dss, arrays)
             for r in range(ndev)]
    if ndev == 1:
        comm = SlabComm(problem.device)
        comm.on_message = on_message
        return [fn(ShardedEngine.from_slab(slabs[0], comm), *args)]
    return run_ranks(_run_task, [(s, fn, args) for s in slabs],
                     device=problem.device, on_message=on_message)
