"""Lagrangian<->Eulerian interpolation (the IBM H/S matrices).

Port of pynama_tpu/ibm/interpolation.py (reference
`src/cases/immersed_boundary.py:170-246`): on the structured GLL grid each
Lagrangian node's Eulerian support is a FIXED (K^dim) window of grid nodes
found by per-axis binary search, so H is a static-shape (L, K^dim) table of
node ids and weights. H acts the same on each velocity component, so the
normal matrix A = H S is kron(C, I_dim) with a small dense (L, L) core C,
Cholesky-factored on the device.

The regularized deltas are evaluated in INDEX space: per axis a Lagrangian
point maps to its fractional node index eta(X) (piecewise-linear inverse of
the axis coordinates) and the kernel argument is |i - eta|, so each H row
sums to 1 exactly on any node spacing, and the same tables work in 3D.

Scalings: H rows are dimensionless kernel products (row sum 1); the spread
carries the reference's dl*h column scale and C = H S = (W Wᵀ)·dl·h
(`immersed_boundary.py:199-205`).

The spread S is deterministic: a `SpreadPlan` lists, for every Euler node
the body touches, its (l, k) slots in a fixed order (a stable sort of the
flat node ids), and S gathers and sums them; no scatter-add, so two calls
on the same inputs give bitwise equal outputs on any device. Every
contraction runs in full precision (TF32 is off, `config.py`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from pynama_tpu_torch.ibm.bodies import KERNELS, KERNEL_SUPPORT


@dataclasses.dataclass(frozen=True)
class IBMOps:
    """Static grid-side tables for the interpolation, on the device."""
    axes: tuple              # dim (np_d,) per-axis grid coordinates
    h: torch.Tensor          # node separation (flux/force scale, 0-d)
    dl: torch.Tensor         # body measure per Lagrangian point (0-d)
    kernel: str
    #: per-axis window width: the kernel support in INDEX units is fixed
    #: (2*ceil(support)+1 nodes) regardless of physical spacing
    kside: int = 5

    @property
    def dim(self):
        return len(self.axes)

    @property
    def n_nodes(self):
        return int(np.prod([a.shape[0] for a in self.axes]))


class SpreadPlan(NamedTuple):
    """The transposed support table of S: `uniq` (U,) the Euler nodes the
    tables touch, ascending; `slots` (U, F) their flat (l*K^dim + k) slots
    in ascending order, padded with L*K^dim (a zero row)."""
    uniq: torch.Tensor
    slots: torch.Tensor


def make_ibm_ops(mesh, dl, kernel="fourGrid", *, device,
                 dtype) -> IBMOps:
    assert getattr(mesh, "is_box", False), \
        "IBM requires a structured box mesh (as the reference)"
    axes_np = [np.asarray(a) for a in mesh.axis_coords]
    kside = 2 * int(np.ceil(KERNEL_SUPPORT[kernel])) + 1
    kside = min(kside, min(a.shape[0] for a in axes_np))
    kw = dict(dtype=dtype, device=device)
    return IBMOps(axes=tuple(torch.as_tensor(a, **kw) for a in axes_np),
                  h=torch.as_tensor(mesh.node_separation(), **kw),
                  dl=torch.as_tensor(dl, **kw), kernel=kernel, kside=kside)


def support_tables(ops: IBMOps, body_xy: torch.Tensor):
    """(L, K^dim) Euler node ids (int64) and index-space dirac weights for
    the Lagrangian points (each row sums to 1 exactly). All on the device:
    the dynamic case recomputes them every step with the same shapes
    (reference rebuildMatrix, immersed_boundary.py:379-385)."""
    phi = KERNELS[ops.kernel]
    K = ops.kside
    half = K // 2
    ar = torch.arange(K, device=body_xy.device)

    def axis_window(axis_coords, x):
        n = axis_coords.shape[0]
        # left-sided, as jnp.searchsorted
        j = torch.clamp(torch.searchsorted(axis_coords, x) - 1, 0, n - 2)
        frac = (x - axis_coords[j]) / (axis_coords[j + 1] - axis_coords[j])
        eta = j.to(x.dtype) + frac                  # fractional node index
        i0 = torch.clamp(j - half, 0, n - K)
        idx = i0[:, None] + ar[None, :]             # (L, K)
        w = phi(torch.abs(idx.to(x.dtype) - eta[:, None]))
        return idx, w

    wins = [axis_window(a, body_xy[:, d].contiguous())
            for d, a in enumerate(ops.axes)]
    L = body_xy.shape[0]
    dim = ops.dim
    if dim == 2:
        (ix, wx), (iy, wy) = wins
        npy = ops.axes[1].shape[0]
        nodes = ix[:, :, None] * npy + iy[:, None, :]
        w = wx[:, :, None] * wy[:, None, :]
    else:
        (ix, wx), (iy, wy), (iz, wz) = wins
        npy, npz = ops.axes[1].shape[0], ops.axes[2].shape[0]
        nodes = (ix[:, :, None, None] * npy
                 + iy[:, None, :, None]) * npz + iz[:, None, None, :]
        w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    return nodes.reshape(L, K**dim), w.reshape(L, K**dim)


def spread_plan(nodes: torch.Tensor) -> SpreadPlan:
    """The transposed table of `nodes` (see SpreadPlan), built on the
    nodes' device: a stable sort of the flat ids, each slot's rank in its
    node's run, and one write of every (node, rank) pair, which are all
    distinct. Reads the run count and the longest run to the host (one
    sync)."""
    ids = nodes.reshape(-1)
    n = ids.numel()
    sids, order = torch.sort(ids, stable=True)
    pos = torch.arange(n, device=ids.device)
    new = torch.ones(n, dtype=torch.bool, device=ids.device)
    new[1:] = sids[1:] != sids[:-1]
    run = torch.cumsum(new, 0) - 1
    start = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                         0).values
    rank = pos - start
    U, F = (int(v) + 1 for v in torch.stack([run[-1], rank.max()]).tolist())
    slots = torch.full((U, F), n, dtype=torch.int64, device=ids.device)
    slots[run, rank] = order
    return SpreadPlan(uniq=sids[new], slots=slots)


def interp_H(ops: IBMOps, nodes, w, vel_nodal: torch.Tensor) -> torch.Tensor:
    """H . vel: (n_nodes, dim) -> (L, dim); rows sum to 1 exactly, so
    constant fields (rigid-body velocities) are reproduced exactly."""
    ve = vel_nodal[nodes]                 # (L, K^dim, dim)
    return torch.einsum("lk,lkc->lc", w, ve)


def spread_S(ops: IBMOps, nodes, w, flux: torch.Tensor, n_nodes: int,
             plan: SpreadPlan | None = None) -> torch.Tensor:
    """S . flux: (L, dim) -> (n_nodes, dim), dl*h column scaling
    (reference immersed_boundary.py:199-205). Each touched node's slots
    are gathered through `plan` (built from `nodes` when not given) and
    summed; the sums are written to distinct rows."""
    if plan is None:
        plan = spread_plan(nodes)
    dim = flux.shape[1]
    vals = (w[:, :, None] * flux[:, None, :] * (ops.dl * ops.h)).reshape(
        -1, dim)
    vals = torch.cat([vals, vals.new_zeros((1, dim))])
    out = flux.new_zeros((n_nodes, dim))
    out[plan.uniq] = vals[plan.slots].sum(dim=1)
    return out


def normal_core(ops: IBMOps, nodes, w) -> torch.Tensor:
    """C (L, L): the per-component core of A = H S = kron(C, I_dim).

    C[l,m] = dl*h * sum over shared Euler nodes of w_l w_m."""
    eq = (nodes[:, None, :, None] == nodes[None, :, None, :]).to(w.dtype)
    overlap = torch.einsum("lk,lmkj,mj->lm", w, eq, w)
    return overlap * ops.h * ops.dl


def normal_core_spgemm(ops: IBMOps, nodes, w) -> np.ndarray:
    """Host assembly of C for large supports (the eq-tensor of
    `normal_core` is (L, L, K^dim, K^dim)) as the sparse product W Wᵀ, in
    float64 numpy through the port's `sparse/spgemm.py`.

    W is the (L, n_nodes) interpolation-weight matrix (each row is one
    Lagrangian point's K^dim window, distinct columns by construction), and
    C = W Wᵀ is the SpGEMM the reference computes as PETSc H.matMult(S)
    (`immersed_boundary.py:199-206`)."""
    from pynama_tpu_torch.sparse.formats import COO
    from pynama_tpu_torch.sparse.spgemm import spgemm

    nodes = nodes.detach().cpu().numpy()
    wv = w.detach().cpu().numpy().astype(np.float64)
    L, Kd = nodes.shape
    rows = torch.as_tensor(np.repeat(np.arange(L, dtype=np.int64), Kd))
    cols = torch.as_tensor(nodes.ravel().astype(np.int64))
    vals = torch.as_tensor(wv.ravel())
    W = COO(row=rows, col=cols, data=vals, shape=(L, ops.n_nodes))
    Wt = COO(row=cols, col=rows, data=vals, shape=(ops.n_nodes, L))
    Ccsr = spgemm(W, Wt)
    C = np.zeros((L, L))
    indptr = Ccsr.indptr.numpy()
    r = np.repeat(np.arange(L), np.diff(indptr))
    C[r, Ccsr.indices.numpy()] = Ccsr.data.numpy()
    return C * float(ops.h) * float(ops.dl)


def correction_cg(ops: IBMOps, nodes, w, vel_nodal, body_vel, flux0,
                  n_nodes, rtol=1e-10, maxiter=200, plan=None):
    """Velocity correction with a MATRIX-FREE solve of C z = -(H v -
    v_body): CG on z -> H(S z) through the same tables, Jacobi-
    preconditioned (diag(C) = dl*h * sum_k w_k^2 per row), warm-started
    from `flux0` (the previous step's flux). Returns (vel_correction, flux,
    (iters, relative_residual)), the last two 0-d device tensors: a stalled
    solve leaves the rigid-body constraint under-enforced, and the caller
    checks them."""
    from pynama_tpu_torch.solver.cg import pcg

    if plan is None:
        plan = spread_plan(nodes)

    def A(z):
        return interp_H(ops, nodes, w,
                        spread_S(ops, nodes, w, z, n_nodes, plan))

    d = ((w * w).sum(dim=1) * ops.h * ops.dl)[:, None]
    rhs = body_vel - interp_H(ops, nodes, w, vel_nodal)
    res = pcg(A, rhs, flux0, M_inv=lambda r: r / d, rtol=rtol,
              maxiter=maxiter)
    corr = spread_S(ops, nodes, w, res.x, n_nodes, plan)
    relres = res.residual / (torch.sqrt((rhs * rhs).sum()) + 1e-300)
    return corr, res.x, (res.iters, relres)


def correction(ops: IBMOps, nodes, w, chol, vel_nodal, body_vel, n_nodes,
               plan=None):
    """One velocity correction (reference computeVelocityCorrection,
    immersed_boundary.py:162-168): solve C z = -(H v - v_body) per
    component with the Cholesky factor of C, return (vel_correction,
    virtual_flux)."""
    rhs = interp_H(ops, nodes, w, vel_nodal) - body_vel
    flux = torch.cholesky_solve(-rhs, chol, upper=False)
    corr = spread_S(ops, nodes, w, flux, n_nodes, plan)
    return corr, flux
