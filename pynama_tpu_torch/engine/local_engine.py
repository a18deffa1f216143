"""Execution engine: the whole KLE/RHS pipeline in element-local layout.

Port of pynama_tpu/engine/local_engine.py, on box meshes and on
unstructured ones (gmsh quads and hexes). All state lives in the local
vector layout of `ops/local.py` — (E, nnode_el*ncomp) — and `EngineOps`, a
frozen dataclass of tensors, carries everything the step functions need.

Pipeline per RHS evaluation (reference evalRHS):

    BC write  : dense-mask merge with a value buffer (constant sides baked
                in, analytic-function sides evaluated and scattered on top)
    KLE solve : matrix-free PCG (or restarted GMRES, krylov="gmres") on
                DSS(x @ K^T), preconditioned by the assembled diagonal
                (Jacobi), fast diagonalization (FDM) or element-wise
                additive Schwarz mixed with Jacobi (pc="schwarz")
    operators : curl/SrT/DivSrT as DSS(x @ matT) + winv scaling
    v (x) v   : component extraction/packing via column gathers

Every operator application is `_apply_mat`, y = DSS(t @ matT). On a box
mesh with `fused=True` (the default) it runs through
`ops/fused.py::fused_apply`: the hand-written CUDA kernel on a GPU, its
plain PyTorch version on the CPU. `fused=False` (the CLI's `-fused off`, a
user's choice, never taken by itself) runs the plain `ops/local.py` route,
`dss(emm(t, matT))`, on any device. Unstructured meshes always take that
route, with per-element matrices (a batched einsum) and the gather DSS:
the fused kernel is a box-mesh kernel, and `fused=True` there only logs so.

K can be sum-factorized (`ops/sumfact.py`, `sumfact=`; on by default on
unstructured meshes, where the dense per-element K would be the largest
array the engine reads): apply_K is then the sumfact product followed by
the DSS — K1's DSS pass alone (`dss_pass`) on a box mesh with
`fused=True`, else the plain `ops/local.py` DSS — and the dense K never
goes to the device.

Correctness relies on every field staying *consistent* (duplicated interface
slots equal): DSS assembles, masks and pointwise scalings are per-node, CG
combines consistent vectors linearly.

The boundary-condition semantics mirror the reference: velocity/vorticity
values are written on all components of every boundary node before each
solve; tangential values are re-imposed on no-slip walls after the
free-slip stage. Constant sides are merged in declaration order into the
constant buffers; analytic-function sides are scattered on top of them,
each in its turn, so a function side wins a shared corner.

Sharded runs (`parallel/sharded_engine.py`) give each rank an EngineOps
of its own slab with a `comm` (`parallel/comm.py::SlabComm`, the
counterpart of the JAX package's `axis_name`): the dots of the Krylov
solves and the RK error norm are psums, the plain DSS exchanges planes
(or interface rows) with the other ranks, and on a box mesh the fused
kernel's raw axis-0 planes `bnd` go to the neighbour ranks and theirs are
added into `y`'s first and last planes. With `overlap_dss` the plain box
DSS is `ops/local.py::dss_overlapped`. `comm=None` is one device.

pc="schwarz" (`preconditioner`) is the reference's weighted additive
overlapping Schwarz by element: z = DSS((free·r·inv_mult) @ KinvT)·inv_mult
with KinvT the element pseudo-inverse (`element_pinv_T`, host numpy f64),
plus half the Jacobi step. Its DSS(t @ KinvT) is `_apply_mat` with KinvT in
place of K^T, so on a box mesh with `fused=True` it is one more K1 launch per
application, and it serves sharded ranks as every other application does.
It needs one element matrix shared by every element: with per-element K
(unstructured meshes) pc falls back to "jacobi", the reference's rule.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pynama_tpu_torch.functions import get_function_lib
from pynama_tpu_torch.ops import local as L
from pynama_tpu_torch.ops import sumfact as S
from pynama_tpu_torch.ops.cg_epilogue import Epilogue
from pynama_tpu_torch.ops.fused import dss_pass, fused_apply
from pynama_tpu_torch.solver.cg import pcg
from pynama_tpu_torch.solver.fdm import (FDMOps, SlabFDM, build_fdm,
                                         fdm_apply, fdm_apply_slab)
from pynama_tpu_torch.solver.gmres import gmres
from pynama_tpu_torch.utils.profiling import span

logger = logging.getLogger("pynama_tpu_torch.engine")


# ---------------------------------------------------------------------------
# operator bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FuncSide:
    """Analytic-function boundary side (time-dependent values)."""
    coords: torch.Tensor          # (k, dim) slot coordinates, engine dtype
    rows: torch.Tensor            # (k,) slot row ids into the (E*nn) axis
    func_name: str
    kind: str
    normal_axis: int


@dataclasses.dataclass(frozen=True)
class EngineOps:
    """Everything the step functions need."""
    # element matrices, transposed (x_local @ matT); on unstructured meshes
    # one per element, (E, nnc_in, nnc_out); KT is empty, (0,), when
    # `sumfact` replaces it
    KT: torch.Tensor              # (nncv, nncv)
    RwT: torch.Tensor             # (nncw, nncv)
    curlT: torch.Tensor           # (nncv, nncw)
    srtT: torch.Tensor            # (nncv, nncs)
    divT: torch.Tensor            # (nncs, nncv)
    # layouts (DSS perms + slot weights) per component family
    lay_v: L.LocalLayout
    lay_w: L.LocalLayout
    lay_s: L.LocalLayout
    # reciprocal lumped weights expanded per family, (E, nnc)
    winv_v: torch.Tensor
    winv_w: torch.Tensor
    winv_s: torch.Tensor
    # masked-system data (E, nncv)
    free_main: torch.Tensor
    free_fs: torch.Tensor
    diag: torch.Tensor
    # BC dense masks and constant-value buffers
    mask_vel: torch.Tensor        # (E, nncv) 1.0 where velocity is imposed
    mask_vort: torch.Tensor       # (E, nncw)
    mask_tang: torch.Tensor       # (E, nncv) no-slip tangential components
    const_vel: torch.Tensor       # (E, nncv) constant boundary velocity
    const_vort: torch.Tensor      # (E, nncw)
    #: tangential values merged per component in side order (wall edges
    #: and corners get different component subsets from two sides)
    const_tang: torch.Tensor      # (E, nncv)
    # v (x) v component shuffles
    P_v2cm: torch.Tensor          # (dim*nn,) interleaved -> comp-major
    P_cm2s: torch.Tensor          # (nncs,) comp-major -> interleaved
    rho: float
    mu: float
    nu: float
    ngl: int
    nelem: tuple
    dim: int
    dim_w: int
    dim_s: int
    is_ns: bool
    cg_rtol: float
    cg_atol: float
    cg_maxiter: int
    #: analytic-function sides, scattered in order over the constant values
    func_sides: tuple = ()
    #: preconditioner: "jacobi" (assembled diagonal), "fdm" (fast
    #: diagonalization; wins cold and one-shot solves) or "schwarz"
    #: (element-wise additive Schwarz + Jacobi; the reference measured 2.7x
    #: Jacobi's iterations and keeps it for experimentation)
    pc: str = "jacobi"
    #: FDM data per masked system; None unless pc == "fdm"
    fdm_main: Optional[FDMOps] = None
    fdm_fs: Optional[FDMOps] = None
    #: Krylov method of the masked solves: "cg" or "gmres"
    krylov: str = "cg"
    #: operator applications through fused_apply (True) or the plain
    #: ops/local.py route (False, the user's `-fused off`); box meshes only
    fused: bool = True
    #: sum-factorized K (ops/sumfact.py) in place of KT; None -> dense KT
    sumfact: Optional[S.SumFactK] = None
    #: this rank's collectives when sharded (parallel/comm.py SlabComm);
    #: None -> one device
    comm: Optional[object] = None
    #: overlap the plain box DSS's plane exchange with its bulk passes
    #: (ops/local.py dss_overlapped); only read when sharded
    overlap_dss: bool = False
    #: the element pseudo-inverse, transposed, (nncv, nncv); None unless
    #: pc == "schwarz"
    KinvT: Optional[torch.Tensor] = None

    @property
    def nn(self):
        return self.ngl ** self.dim


#: the array fields of EngineOps on every mesh, by dotted path, as
#: `ops_from_numpy` takes them (layout perms as one (dim, nnc) integer
#: array, (0, nnc) on unstructured meshes)
ARRAY_FIELDS = (
    "KT", "RwT", "curlT", "srtT", "divT",
    "lay_v.inv_mult", "lay_v.perms", "lay_w.inv_mult", "lay_w.perms",
    "lay_s.inv_mult", "lay_s.perms",
    "winv_v", "winv_w", "winv_s", "free_main", "free_fs", "diag",
    "mask_vel", "mask_vort", "mask_tang", "const_vel", "const_vort",
    "const_tang", "P_v2cm", "P_cm2s", "rho", "mu", "nu",
)
#: more array fields on unstructured meshes (structured=False): each
#: layout's fan-in table and node table
UNSTRUCTURED_FIELDS = tuple(f"lay_{fam}.{k}" for fam in "vws"
                            for k in ("incidence", "cell_nodes"))
#: the SumFactK fields, present when sumfact replaces the dense KT
SUMFACT_FIELDS = tuple(f"sumfact.{k}" for k in S.FIELDS)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _comp_perm_idx(nn: int, ncomp: int) -> np.ndarray:
    """Gather index: interleaved -> component-major, t_cm = t[:, idx]."""
    dst = np.arange(ncomp * nn)
    comp = dst // nn
    node = dst % nn
    return node * ncomp + comp


def _comp_unperm_idx(nn: int, ncomp: int) -> np.ndarray:
    """Gather index: component-major -> interleaved, t = t_cm[:, idx]."""
    dst = np.arange(nn * ncomp)
    node = dst // ncomp
    comp = dst % ncomp
    return comp * nn + node


def _vtensv_pairs(dim: int):
    """Strain-slot component pairs (reference computeVtensV)."""
    if dim == 2:
        return [(0, 0), (0, 1), (1, 1)]
    return [(0, 0), (0, 1), (1, 1), (1, 2), (2, 2), (2, 0)]


def _engine_arrays(mesh, bc, em_K, em_Rw, op_curl, op_srt, op_div,
                   op_weight, rho, mu) -> dict:
    """The numpy arrays of an EngineOps (keys: ARRAY_FIELDS, and
    UNSTRUCTURED_FIELDS on an unstructured mesh): float64, but the element
    matrices keep their own dtype (per-element ones are built in the
    runtime dtype) and are transposed views."""
    dim, dim_w, dim_s = mesh.dim, mesh.dim_w, mesh.dim_s
    nn = mesh.nnode_el
    E = mesh.n_cells
    box = getattr(mesh, "is_box", False)
    cell_nodes = np.asarray(mesh.cell_nodes)
    counts = np.bincount(cell_nodes.ravel(), minlength=mesh.n_nodes)
    inv = 1.0 / counts[cell_nodes]
    out = {}
    for fam, c in (("v", dim), ("w", dim_w), ("s", dim_s)):
        out[f"lay_{fam}.inv_mult"] = np.repeat(inv, c, axis=1)
        out[f"lay_{fam}.perms"] = (
            np.stack(L.perm_arrays(mesh.ngl, dim, c)) if box
            else np.zeros((0, nn * c), dtype=np.int64))
        if not box:
            out[f"lay_{fam}.incidence"] = np.asarray(mesh.incidence)
            out[f"lay_{fam}.cell_nodes"] = cell_nodes

    # lumped weights: assemble (DSS of tiled element weights), then 1/w per
    # node, expanded per family
    wtile = np.broadcast_to(np.asarray(op_weight, dtype=np.float64),
                            (E, nn)).copy()
    winv = 1.0 / L.dss_np(mesh, wtile, 1)                  # (E, nn)
    for fam, c in (("v", dim), ("w", dim_w), ("s", dim_s)):
        out[f"winv_{fam}"] = np.repeat(winv, c, axis=1)

    out["free_main"] = L.to_local(mesh, bc.free_main.astype(np.float64))
    out["free_fs"] = L.to_local(mesh, bc.free_fs.astype(np.float64))
    K_np = np.asarray(em_K)
    de = np.diagonal(K_np, axis1=-2, axis2=-1) if K_np.ndim == 3 \
        else np.tile(np.diagonal(K_np)[None, :], (E, 1))
    out["diag"] = L.dss_np(mesh, de, dim)

    # BC masks + constant values (dense, merged in side order)
    n_nodes = mesh.n_nodes
    mvel = np.zeros((n_nodes, dim))
    mvort = np.zeros((n_nodes, dim_w))
    mtang = np.zeros((n_nodes, dim))
    cvel = np.zeros((n_nodes, dim))
    cvort = np.zeros((n_nodes, dim_w))
    ctang = np.zeros((n_nodes, dim))
    for s in bc.sides:
        mvel[s.nodes, :] = 1.0
        mvort[s.nodes, :] = 1.0
        if s.kind == "no-slip":
            for d in range(dim):
                if d != s.normal_axis:
                    mtang[s.nodes, d] = 1.0
                    if s.func is None:
                        ctang[s.nodes, d] = s.velocity[d]
        if s.func is None:
            cvel[s.nodes, :] = s.velocity
            cvort[s.nodes, :] = s.vorticity
    for key, a in (("mask_vel", mvel), ("mask_vort", mvort),
                   ("mask_tang", mtang), ("const_vel", cvel),
                   ("const_vort", cvort), ("const_tang", ctang)):
        out[key] = L.to_local(mesh, a)

    tr = lambda a: np.swapaxes(np.asarray(a), -1, -2)
    out.update(KT=tr(K_np), RwT=tr(em_Rw), curlT=tr(op_curl),
               srtT=tr(op_srt), divT=tr(op_div),
               P_v2cm=_comp_perm_idx(nn, dim),
               P_cm2s=_comp_unperm_idx(nn, dim_s),
               rho=np.asarray(rho, dtype=np.float64),
               mu=np.asarray(mu, dtype=np.float64),
               nu=np.asarray(mu / rho, dtype=np.float64))
    return out


def element_pinv_T(em_K) -> np.ndarray:
    """The transposed pseudo-inverse of one shared element K, float64 (the
    reference's Schwarz setup). K_e is symmetric positive semi-definite with
    a small null space (per-component constants survive the stiffness and
    the penalties): invert the symmetrized matrix's eigenvalues above
    1e-10·λmax and drop the directions below, which the Jacobi part of the
    preconditioner covers."""
    Ke = np.asarray(em_K, dtype=np.float64)
    lam, Q = np.linalg.eigh(0.5 * (Ke + Ke.T))
    cut = 1e-10 * lam.max()
    inv_lam = np.where(lam > cut, 1.0 / np.maximum(lam, cut), 0.0)
    return ((Q * inv_lam[None, :]) @ Q.T).T


def _engine_func_sides(mesh, bc) -> list:
    """FuncSide per analytic-function side, numpy: the coordinates and row
    ids of every element slot of the side's nodes."""
    n_nodes = mesh.n_nodes
    flat = np.asarray(mesh.cell_nodes).ravel()
    out = []
    for s in bc.sides:
        if s.func is None:
            continue
        onside = np.zeros(n_nodes, dtype=bool)
        onside[s.nodes] = True
        rows = np.where(onside[flat])[0]
        out.append(FuncSide(
            coords=mesh.coords[flat[rows]], rows=rows,
            func_name=s.func.__name__.rsplit(".", 1)[-1], kind=s.kind,
            normal_axis=int(s.normal_axis)))
    return out


def ops_from_numpy(arrays: dict, *, ngl, nelem, dim, dim_w, dim_s, is_ns,
                   cg_rtol, cg_atol, cg_maxiter, device, dtype,
                   func_sides=(), pc="jacobi", fdm_main=None,
                   fdm_fs=None, krylov="cg", fused=True,
                   structured=True, comm=None,
                   overlap_dss=False) -> EngineOps:
    """EngineOps from numpy arrays keyed by ARRAY_FIELDS, plus
    UNSTRUCTURED_FIELDS when `structured` is False, SUMFACT_FIELDS when
    K is sum-factorized and "KinvT" when pc is "schwarz" (the fields of
    the JAX package's EngineOps carry over one to one). Float arrays are
    cast to `dtype`, index arrays to int64, scalars to Python floats.
    `func_sides` holds objects with the FuncSide fields whose arrays numpy
    can read (either package's FuncSide); `fdm_main`/`fdm_fs` are the port's FDMOps (or, on a rank's
    slab, SlabFDM) on `device`. A sharded rank's arrays may hold
    "lay_{v,w,s}.iface" (the partition-interface rows); `comm` and
    `overlap_dss` go to the EngineOps as they are."""
    def f(key):
        return torch.as_tensor(np.array(arrays[key]), dtype=dtype,
                               device=device).contiguous()

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    nelem = tuple(int(n) for n in nelem)

    def lay(fam, ncomp):
        perms = np.asarray(arrays[f"lay_{fam}.perms"])
        more = {} if structured else dict(
            incidence=idx(arrays[f"lay_{fam}.incidence"]),
            cell_nodes=idx(arrays[f"lay_{fam}.cell_nodes"]),
            structured=False, mesh_dim=int(dim))
        if f"lay_{fam}.iface" in arrays:
            more["iface"] = idx(arrays[f"lay_{fam}.iface"])
        return L.LocalLayout(
            perms=tuple(idx(p) for p in perms),
            inv_mult=f(f"lay_{fam}.inv_mult"), ngl=int(ngl), nelem=nelem,
            ncomp=int(ncomp), **more)

    sumfact = None
    if SUMFACT_FIELDS[0] in arrays:
        sumfact = S.sumfact_from_numpy(
            {k: arrays[f"sumfact.{k}"] for k in S.FIELDS}, device=device,
            dtype=dtype)

    KinvT = f("KinvT") if "KinvT" in arrays else None
    if pc == "schwarz" and KinvT is None:
        raise ValueError("pc='schwarz' needs the element pseudo-inverse "
                         "'KinvT' among the arrays")

    fsides = tuple(FuncSide(
        coords=torch.as_tensor(np.array(fs.coords), dtype=dtype,
                               device=device),
        rows=idx(fs.rows), func_name=str(fs.func_name), kind=str(fs.kind),
        normal_axis=int(fs.normal_axis)) for fs in func_sides)
    return EngineOps(
        KT=f("KT"), RwT=f("RwT"), curlT=f("curlT"), srtT=f("srtT"),
        divT=f("divT"),
        lay_v=lay("v", dim), lay_w=lay("w", dim_w), lay_s=lay("s", dim_s),
        winv_v=f("winv_v"), winv_w=f("winv_w"), winv_s=f("winv_s"),
        free_main=f("free_main"), free_fs=f("free_fs"), diag=f("diag"),
        mask_vel=f("mask_vel"), mask_vort=f("mask_vort"),
        mask_tang=f("mask_tang"), const_vel=f("const_vel"),
        const_vort=f("const_vort"), const_tang=f("const_tang"),
        P_v2cm=idx(arrays["P_v2cm"]), P_cm2s=idx(arrays["P_cm2s"]),
        rho=float(arrays["rho"]), mu=float(arrays["mu"]),
        nu=float(arrays["nu"]),
        ngl=int(ngl), nelem=nelem, dim=int(dim), dim_w=int(dim_w),
        dim_s=int(dim_s), is_ns=bool(is_ns), cg_rtol=float(cg_rtol),
        cg_atol=float(cg_atol), cg_maxiter=int(cg_maxiter),
        func_sides=fsides, pc=pc, fdm_main=fdm_main, fdm_fs=fdm_fs,
        krylov=krylov, fused=bool(fused), sumfact=sumfact, comm=comm,
        overlap_dss=bool(overlap_dss), KinvT=KinvT)


def ops_to_numpy(ops: EngineOps) -> dict:
    """The inverse of `ops_from_numpy`'s array part: every array field of
    `ops` as a host numpy array in its own dtype, keyed as ops_from_numpy
    takes them (ARRAY_FIELDS, UNSTRUCTURED_FIELDS on an unstructured mesh,
    SUMFACT_FIELDS with a sum-factorized K, "KinvT" under pc="schwarz")."""
    keys = ARRAY_FIELDS
    if not ops.lay_v.structured:
        keys = keys + UNSTRUCTURED_FIELDS
    if ops.sumfact is not None:
        keys = keys + SUMFACT_FIELDS
    if ops.KinvT is not None:
        keys = keys + ("KinvT",)
    out = {}
    for key in keys:
        obj = ops
        for part in key.split("."):
            obj = getattr(obj, part)
        if key.endswith(".perms"):
            lay = getattr(ops, key.split(".")[0])
            obj = torch.stack(obj) if obj else torch.zeros(
                (0, lay.nnc), dtype=torch.int64)
        out[key] = obj.detach().cpu().numpy() \
            if isinstance(obj, torch.Tensor) else np.asarray(obj)
    return out


def build_engine(mesh, bc, em_K, em_Rw, op_curl, op_srt, op_div, op_weight,
                 rho, mu, *, device, dtype, cg_rtol=1e-12, cg_atol=0.0,
                 cg_maxiter=2000, pc="jacobi", krylov="cg",
                 fused=True, sumfact=None, basis=None) -> EngineOps:
    """Assemble EngineOps from setup-time numpy data (any mesh).

    em_*/op_* are the dense element matrices from `elements/kle.py` (shared,
    or one per element on an unstructured mesh); op_weight is the
    per-local-node quadrature weight used for lumping. pc="fdm" builds the
    fast-diagonalization data of both masked systems (numpy setup, tensors
    on `device`); as in the reference, pc falls back to "jacobi" when
    `build_fdm` finds no tensor structure (every unstructured mesh).
    pc="schwarz" builds the element pseudo-inverse on the host
    (`element_pinv_T`) when em_K is one shared matrix; with per-element K
    (unstructured meshes) pc falls back to "jacobi", as in the reference.
    krylov="gmres" solves the masked systems with restarted GMRES(30)
    instead of PCG. fused=False applies every operator through the plain
    ops/local.py route instead of fused_apply. sumfact (None: on for
    unstructured meshes, off for box meshes, the reference's rule)
    replaces the dense K by `ops/sumfact.py`'s product, built from
    `basis` (the TensorBasis); without a basis K stays dense.
    """
    if krylov not in ("cg", "gmres"):
        raise ValueError(f"unknown Krylov method '{krylov}'")
    if pc not in ("jacobi", "fdm", "schwarz"):
        raise ValueError(f"unknown preconditioner '{pc}'")
    box = getattr(mesh, "is_box", False)
    arrays = _engine_arrays(mesh, bc, em_K, em_Rw, op_curl, op_srt, op_div,
                            op_weight, rho, mu)
    use_sf = (not box) if sumfact is None else bool(sumfact)
    if use_sf and basis is not None:
        sf = S.sumfact_arrays(basis, mesh.cell_corners)
        arrays.update({f"sumfact.{k}": v for k, v in sf.items()})
        arrays["KT"] = np.zeros((0,))
    if fused and not box:
        logger.info("fused=True: the fused kernel serves box meshes only; "
                    "this unstructured mesh takes the per-element route "
                    "and the gather DSS")
    fdm_main = fdm_fs = None
    if pc == "fdm":
        diag_g = L.to_global(mesh, arrays["diag"], mesh.dim)
        kw = dict(device=device, dtype=dtype, diag_global=diag_g)
        fdm_main = build_fdm(mesh, bc.free_main, **kw)
        fdm_fs = build_fdm(mesh, bc.free_fs, **kw) \
            if bc.needs_fs_stage else None
        if fdm_main is None:
            logger.warning("pc='fdm': the free-dof mask has no tensor "
                           "structure to diagonalize; using pc='jacobi' "
                           "(the reference's rule)")
            pc, fdm_fs = "jacobi", None
    if pc == "schwarz":
        if np.ndim(em_K) == 2:
            arrays["KinvT"] = element_pinv_T(em_K)
        else:
            logger.warning("pc='schwarz': the elements have matrices of "
                           "their own, no shared one to invert; using "
                           "pc='jacobi' (the reference's rule)")
            pc = "jacobi"
    return ops_from_numpy(
        arrays, ngl=mesh.ngl,
        nelem=mesh.nelem if box else (mesh.n_cells,), dim=mesh.dim,
        dim_w=mesh.dim_w, dim_s=mesh.dim_s, is_ns=bc.needs_fs_stage,
        cg_rtol=cg_rtol, cg_atol=cg_atol, cg_maxiter=cg_maxiter,
        device=device, dtype=dtype, func_sides=_engine_func_sides(mesh, bc),
        pc=pc, fdm_main=fdm_main, fdm_fs=fdm_fs, krylov=krylov,
        fused=fused, structured=box)


# ---------------------------------------------------------------------------
# boundary conditions
# ---------------------------------------------------------------------------

def _value_buffer(ops: EngineOps, time, attr: str,
                  const: torch.Tensor | None = None) -> torch.Tensor:
    """(E, nnc) buffer holding boundary values on boundary slots.

    Constant sides are baked in; analytic-function sides are evaluated on
    their slot coordinates (on the device; alpha is a host float, so no
    sync) and written on top, one side after the other in side order; on
    an unstructured mesh that loop is a `bc.func` span with attr sides."""
    if const is None:
        const = ops.const_vel if attr == "velocity" else ops.const_vort
    if not ops.func_sides:
        return const
    ncomp = ops.dim if attr == "velocity" else ops.dim_w
    U = const.reshape(-1, ncomp).clone()
    if ops.lay_v.structured:
        _write_func_sides(ops, U, time, attr)
    else:
        # a `bc.func` span on the unstructured route only, as the other
        # spans of that route (apply_k.element, dss.gather)
        with span("bc.func") as sp:
            sp.attrs["sides"] = len(ops.func_sides)
            _write_func_sides(ops, U, time, attr)
    return U.reshape(const.shape)


def _write_func_sides(ops: EngineOps, U, time, attr: str):
    """Each analytic-function side's values at `time` into the rows of U
    (E*nn, ncomp), in side order."""
    for fs in ops.func_sides:
        lib = get_function_lib(fs.func_name)
        a = lib.alpha(ops.nu, time)
        U[fs.rows] = getattr(lib, attr)(fs.coords, a).to(U.dtype)


def apply_velocity_bc(ops: EngineOps, vel, time):
    """setValuesToVec for velocity."""
    U = _value_buffer(ops, time, "velocity")
    return vel * (1.0 - ops.mask_vel) + U * ops.mask_vel


def apply_vorticity_bc(ops: EngineOps, vort, time):
    U = _value_buffer(ops, time, "vorticity")
    return vort * (1.0 - ops.mask_vort) + U * ops.mask_vort


def apply_tangential_bc(ops: EngineOps, vel, time):
    """Re-impose tangential wall velocity after the FS stage
    (setTangentialValuesToVec)."""
    U = _value_buffer(ops, time, "velocity", const=ops.const_tang)
    return vel * (1.0 - ops.mask_tang) + U * ops.mask_tang


# ---------------------------------------------------------------------------
# operator applications
# ---------------------------------------------------------------------------

def _sharded(ops: EngineOps) -> bool:
    return ops.comm is not None and ops.comm.size > 1


def _dot_v(ops: EngineOps):
    inv = ops.lay_v.inv_mult
    sharded = _sharded(ops)

    def dot(a, b):
        s = (a * b * inv).sum()
        return ops.comm.psum(s) if sharded else s

    return dot


def _dots_v(ops: EngineOps):
    """pcg's `dots`: several `_dot_v` values, one psum for all of them
    when sharded."""
    inv = ops.lay_v.inv_mult

    def dots(pairs):
        s = [(a * b * inv).sum() for a, b in pairs]
        return list(ops.comm.psum(torch.stack(s))) if _sharded(ops) else s

    return dots


def _dss(ops: EngineOps, lay, t):
    """Plain DSS dispatch: on an unstructured mesh the gather DSS, a
    `dss.gather` span with attr ncomp; the overlapped variant when sharded
    with overlap_dss on a box mesh."""
    if not lay.structured:
        with span("dss.gather") as sp:
            sp.attrs["ncomp"] = lay.ncomp
            return L.dss(lay, t, ops.comm)
    if _sharded(ops) and ops.overlap_dss:
        return L.dss_overlapped(lay, L.make_plane_layout(lay), t, ops.comm)
    return L.dss(lay, t, ops.comm)


def _add_neighbour_planes(ops: EngineOps, lay, y, bnd):
    """Sharded box mesh: send K1's raw boundary planes `bnd` to the
    neighbour ranks and add theirs into y's first and last axis-0 planes
    (the plane exchange of a distributed operator application). Both ranks
    of an interface add the same two planes, in either order: the sums are
    bitwise equal."""
    if not _sharded(ops):
        return y
    from_left, from_right = ops.comm.exchange(bnd[0], bnd[1])
    nnc, plane = lay.nnc, lay.plane_cols
    g = y.view(ops.nelem[0], -1, nnc)
    g[0, :, :plane] += from_left
    g[-1, :, nnc - plane:] += from_right
    return y


def _apply_mat(ops: EngineOps, lay, t, matT):
    """y = DSS(t @ matT), the one hot operator-application pattern: on a
    box mesh the fused kernel (its plain version on the CPU), plus the
    neighbour ranks' planes when sharded; with ops.fused False, or on an
    unstructured mesh, the plain ops/local.py route."""
    if ops.fused and lay.structured:
        y, bnd = fused_apply(t, matT, ops.nelem, ops.ngl, lay.ncomp)
        return _add_neighbour_planes(ops, lay, y, bnd)
    return _dss(ops, lay, L.emm(t, matT))


def apply_K(ops: EngineOps, v):
    """K v assembled: the dense route of _apply_mat, or with ops.sumfact
    the sum-factorized product and then the DSS (K1's DSS pass alone on a
    box mesh with ops.fused, its planes exchanged when sharded; else the
    plain one). On an unstructured mesh the element product, whichever
    computes it, is an `apply_k.element` span with attrs route ("sumfact"
    or "dense"), E and ngl, and the DSS the gather DSS."""
    if not ops.lay_v.structured:
        with span("apply_k.element") as sp:
            sp.attrs["route"] = "dense" if ops.sumfact is None \
                else "sumfact"
            sp.attrs["E"], sp.attrs["ngl"] = v.shape[0], ops.ngl
            z = L.emm(v, ops.KT) if ops.sumfact is None \
                else S.apply_sumfact_k(ops.sumfact, v)
        return _dss(ops, ops.lay_v, z)
    if ops.sumfact is not None:
        z = S.apply_sumfact_k(ops.sumfact, v)
        if ops.fused:
            y, bnd = dss_pass(z, ops.nelem, ops.ngl, ops.dim)
            return _add_neighbour_planes(ops, ops.lay_v, y, bnd)
        return _dss(ops, ops.lay_v, z)
    return _apply_mat(ops, ops.lay_v, v, ops.KT)


def curl(ops: EngineOps, v):
    """Nodal curl (row-scaled assembled Curl)."""
    return _apply_mat(ops, ops.lay_w, v, ops.curlT) * ops.winv_w


def srt(ops: EngineOps, v):
    return _apply_mat(ops, ops.lay_s, v, ops.srtT) * ops.winv_s


def div_srt(ops: EngineOps, s):
    return _apply_mat(ops, ops.lay_v, s, ops.divT) * ops.winv_v


def vtensv(ops: EngineOps, vel):
    """v (x) v packed into strain slots via component-major shuffles."""
    nn, dim = ops.nn, ops.dim
    cm = vel[:, ops.P_v2cm]                     # (E, dim*nn) component-major
    comps = [cm[:, k * nn:(k + 1) * nn] for k in range(dim)]
    prods = torch.cat(
        [comps[i] * comps[j] for i, j in _vtensv_pairs(dim)], dim=1)
    return prods[:, ops.P_cm2s]                 # -> interleaved strain


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

class Precond(NamedTuple):
    """A masked system's preconditioner, as `preconditioner` builds it.
    `loop` is its form on vectors that are exactly zero on the constrained
    dofs, the CG's (see `preconditioner`'s contract); `dmask` Jacobi's
    divisor (loop(r) == r / dmask), else None. Called, it is the full
    M_inv, which masks its input and passes `con*r` through, for GMRES,
    whose vectors are not zero there. `con` (1 - free) only where that
    needs it: Jacobi's keeps no such vector alive through a solve."""
    loop: Callable
    free: torch.Tensor
    con: torch.Tensor | None
    dmask: torch.Tensor | None = None

    def __call__(self, r):
        if self.dmask is not None:
            return self.loop(r)     # dmask is 1 on con: r passes through
        return self.loop(self.free * r) + self.con * r


def preconditioner(ops: EngineOps, free, fdm=None) -> Precond:
    """The preconditioner of the masked system with free-dof mask `free`:
    FDM when ops.pc == "fdm" and `fdm` (that system's FDMOps, or a rank's
    SlabFDM) is given, Schwarz when ops.pc == "schwarz", else Jacobi.

    CONTRACT: z = M_inv(r) keeps exact zeros on the constrained dofs
    (z_con == 0 whenever r_con == 0). _masked_solve's A0/A split rests on
    it: the in-loop operator drops the input mask and the `con*v`
    passthrough because every loop vector stays exactly zero there. The
    same holds of M_inv's own input mask and `con*r`, so CG takes
    `Precond.loop`, M_inv without them: FDM and Schwarz mask their output
    with `free`, and the Jacobi divide maps zeros to zeros."""
    con = 1.0 - free
    if ops.pc == "fdm" and isinstance(fdm, SlabFDM):
        def loop(r):
            return free * fdm_apply_slab(fdm, r, ops.nelem, ops.ngl,
                                         ops.comm)
        return Precond(loop, free, con)
    if ops.pc == "fdm" and fdm is not None:
        def loop(r):
            return free * fdm_apply(fdm, r, nelem=ops.nelem, ngl=ops.ngl)
        return Precond(loop, free, con)
    dmask = free * ops.diag + con
    if ops.pc == "schwarz":
        # weighted additive overlapping Schwarz by element
        # (M^-1 = sum_e R^T D K_e^+ D R, SPSD) mixed with Jacobi to cover
        # the element null space; both restricted to the free subspace
        inv_mult = ops.lay_v.inv_mult

        def loop(r):
            z = _apply_mat(ops, ops.lay_v, r * inv_mult, ops.KinvT) \
                * inv_mult
            return free * z + 0.5 * r / dmask
        return Precond(loop, free, con)
    return Precond(lambda r: r / dmask, free, None, dmask)


def _cg_epilogue(ops: EngineOps, free, pc: Precond):
    """pcg's fused epilogue for the masked system, or None on a sharded
    engine, whose dot products need a psum between the partial sums and
    the scalars. Its operator is the loop's `A` without the output mask;
    its preconditioner Jacobi's divisor, folded into the kernels, or else
    pcg's eager M_inv."""
    if _sharded(ops):
        return None
    return Epilogue(apply=lambda v: apply_K(ops, v), free=free,
                    inv_mult=ops.lay_v.inv_mult, dmask=pc.dmask)


def _masked_solve(ops: EngineOps, free, vort, vel, stats=None, fdm=None,
                  stage="main"):
    """Solve the Dirichlet-condensed KLE system on the free subspace with
    preconditioned CG, or GMRES when ops.krylov == "gmres" (the
    preconditioner of `preconditioner`). `stats`, when a list, gets the
    solve's (iters, loop_applies) for CG (see solver/cg.py CGResult: the A0
    residual is not counted) or (iters, applies) for GMRES (see
    solver/gmres.py GMRESResult: every application counted). Either solver
    applies the preconditioner once more than the count. The solve is a
    `kle.solve` span with attrs method, stage ("fs" or "main"),
    loop_applies (the count above, a host int) and iters (a device
    tensor); a CG solve also with epilogue: "fused" where pcg runs its
    loop through ops/cg_epilogue.py (`_cg_epilogue`), else "eager"."""
    with span("kle.solve") as sp:
        sp.attrs["method"], sp.attrs["stage"] = ops.krylov, stage
        con = 1.0 - free
        vc = con * vel
        b = free * (_apply_mat(ops, ops.lay_v, vort, ops.RwT)
                    - apply_K(ops, vc)) + vc

        def A0(v):
            """Full Dirichlet-condensed operator — initial residual only."""
            return free * apply_K(ops, free * v) + con * v

        def A(v):
            """In-loop operator: every CG loop vector is exactly zero on the
            constrained dofs (r0_con = b_con - A0(x0)_con = vc - vc = 0, and
            Ap/z/p inherit the zeros; see `preconditioner`'s contract), so
            `free*v == v` bitwise and `con*v` vanishes; dropping them saves
            two full passes per iteration with a bitwise-identical
            trajectory."""
            return free * apply_K(ops, v)

        pc = preconditioner(ops, free, fdm)
        if ops.krylov == "gmres":
            res = gmres(A0, b, free * vel + vc, M_inv=pc,
                        rtol=ops.cg_rtol, atol=ops.cg_atol,
                        maxiter=ops.cg_maxiter, dot=_dot_v(ops))
            counted = res.applies
        else:
            ep = _cg_epilogue(ops, free, pc)
            sp.attrs["epilogue"] = "eager" if ep is None else "fused"
            # r0 is zero on the constrained dofs too (A's docstring): the
            # prologue takes the loop's form of M_inv as well
            res = pcg(A, b, free * vel + vc, M_inv=pc.loop,
                      rtol=ops.cg_rtol, atol=ops.cg_atol,
                      maxiter=ops.cg_maxiter, dot=_dot_v(ops), A0=A0,
                      dots=_dots_v(ops), epilogue=ep)
            counted = res.loop_applies
        sp.attrs["loop_applies"], sp.attrs["iters"] = counted, res.iters
    if stats is not None:
        stats.append((res.iters, counted))
    return res.x


def solve_kle_local(ops: EngineOps, vort, vel, time, stats=None):
    """BC application + (two-stage) KLE solve, local layout (evalRHS
    pre-solve chain). `stats`, when a list, gets one pair per solve (see
    _masked_solve; free-slip stage first on no-slip problems). Each BC
    write is an `rhs.bc` span."""
    with span("rhs.bc"):
        vort = apply_vorticity_bc(ops, vort, time)
    with span("rhs.bc"):
        vel = apply_velocity_bc(ops, vel, time)
    if ops.is_ns:
        vel_fs = _masked_solve(ops, ops.free_fs, vort, vel, stats,
                               fdm=ops.fdm_fs, stage="fs")
        with span("rhs.bc"):
            vel_fs = apply_tangential_bc(ops, vel_fs, time)
        vort = curl(ops, vel_fs)
    vel = _masked_solve(ops, ops.free_main, vort, vel, stats,
                        fdm=ops.fdm_main)
    return vort, vel


def rhs_local(ops: EngineOps, time, vort, vel, stats=None):
    """d(vort)/dt in local layout (evalRHS), an `rhs.eval` span."""
    with span("rhs.eval"):
        _, vel = solve_kle_local(ops, vort, vel, time, stats)
        vtv = vtensv(ops, vel)
        aux1 = 2.0 * ops.mu * srt(ops, vel) - ops.rho * vtv
        rhs_v = div_srt(ops, aux1) / ops.rho
        f = curl(ops, rhs_v)
    return f, vel


def rk_error_norm(ops: EngineOps, e):
    """Ownership-weighted RMS over global vorticity dofs."""
    n_glob = ops.lay_w.inv_mult.sum()   # == n_nodes*dim_w (this rank's share)
    ss = (e * e * ops.lay_w.inv_mult).sum()
    if _sharded(ops):
        ss, n_glob = ops.comm.psum(torch.stack([ss, n_glob]))
    return torch.sqrt(ss / n_glob)
