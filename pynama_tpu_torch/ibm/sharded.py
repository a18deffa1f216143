"""Slab-sharded IBM velocity correction (domain-decomposed H/S).

Port of pynama_tpu/ibm/sharded.py (the reference runs IBM cases under
`mpiexec -n N` like every case, through PETSc's distributed H/S). The
correction is

    H-gather   : (L, dim) = sum over Euler support nodes   (tiny output)
    (L,L) solve: replicated dense Cholesky, or matrix-free CG
    S-spread   : add w * z * dl * h onto the support nodes

so under the slab split of `parallel/sharded_engine.py` the H/S tables are
written in the LOCAL SLOT ids of each rank's element-local state (as the
analytic-function boundary rows are): each rank gathers its partial H·v
with ownership-corrected weights (w / slot multiplicity), one psum gives
every rank the full (L, dim) interpolation, the small solve runs on every
rank on the same bits, and each rank spreads the correction onto its own
slots. Every slot of a node receives the same add, so the local state
stays consistent.

The spread goes through a stable-sort plan (`ibm/interpolation.py::
spread_plan` over the local slot table), not a scatter-add: each slot sums
its contributions in a fixed order, so the result is bitwise repeatable.
"""
from __future__ import annotations

import numpy as np
import torch

from pynama_tpu_torch.ibm.interpolation import spread_plan


def build_node_slot_map(mesh, ndev: int):
    """Position-independent node -> global-slot map (mesh connectivity
    only, built once): (slots_of (n_nodes, maxm) with pad = E*nn, counts
    (n_nodes,)). A moving body's per-step conversion to one rank's local
    slots is then a gather and a range test (`dynamic_tables_local`).
    `mesh` needs `cell_nodes` and `n_nodes`."""
    cn = np.asarray(mesh.cell_nodes)
    E, nn = cn.shape
    if E % ndev != 0:
        raise ValueError(f"n_cells={E} not divisible by {ndev} devices")
    n_nodes = mesh.n_nodes
    counts = np.bincount(cn.ravel(), minlength=n_nodes)
    maxm = int(counts.max())
    order = np.argsort(cn.ravel(), kind="stable")
    flat = cn.ravel()[order]
    starts = np.r_[0, np.cumsum(counts[:-1])]
    within = np.arange(flat.size) - starts[flat]
    slots_of = np.full((n_nodes, maxm), E * nn, dtype=np.int64)
    slots_of[flat, within] = order
    return slots_of, counts


def dynamic_tables_local(slots_of, counts, nodes, w, nloc: int, rank: int):
    """Global support tables (L, Kd) -> this rank's local-slot tables
    (L, S), on the device: the moving-body form of
    `build_ibm_shard_tables`, with the same meaning. `nloc = E_loc*nn` is
    the local pad id; gather weights are w/mult, spread weights w, both 0
    outside the rank's slots."""
    gsl = slots_of[nodes]                                # (L, Kd, maxm)
    lo = rank * nloc
    m = (gsl >= lo) & (gsl < lo + nloc)
    loc = torch.where(m, gsl - lo, torch.full_like(gsl, nloc))
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    gw = torch.where(m, (w / counts[nodes])[..., None], zero)
    sw = torch.where(m, w[..., None], zero)
    L = nodes.shape[0]
    return loc.reshape(L, -1), gw.reshape(L, -1), sw.reshape(L, -1)


def build_ibm_shard_tables(mesh, nodes_tab, w_tab, ndev: int):
    """Per-rank local-slot tables for the H/S application, numpy.

    Returns (slots, gw, sw), each (ndev, L, S) with S = K^dim * the largest
    slot multiplicity. `slots` holds local slot ids into a rank's flattened
    (E_loc*nn) node axis (pad and other ranks' slots = E_loc*nn); `gw` are
    the H-gather weights w/mult (a node's slots summed over every rank give
    its nodal value once); `sw` the S-spread weights w (every slot of a
    node receives the whole add)."""
    cn = np.asarray(mesh.cell_nodes)
    E, nn = cn.shape
    E_loc = E // ndev
    slots_of, counts = build_node_slot_map(mesh, ndev)
    nodes = np.asarray(nodes_tab)                       # (L, Kd)
    w = np.asarray(w_tab, dtype=np.float64)             # (L, Kd)
    L, Kd = nodes.shape
    gslots = slots_of[nodes]                            # (L, Kd, maxm)
    valid = gslots < E * nn
    gw_g = np.where(valid, (w / counts[nodes])[..., None], 0.0)
    sw_g = np.where(valid, w[..., None], 0.0)
    S = Kd * slots_of.shape[1]
    pad_loc = E_loc * nn
    slots = np.full((ndev, L, S), pad_loc, dtype=np.int64)
    gw = np.zeros((ndev, L, S))
    sw = np.zeros((ndev, L, S))
    fslots = gslots.reshape(L, S)
    for d in range(ndev):
        lo, hi = d * pad_loc, (d + 1) * pad_loc
        m = (fslots >= lo) & (fslots < hi)
        slots[d][m] = fslots[m] - lo
        gw[d][m] = gw_g.reshape(L, S)[m]
        sw[d][m] = sw_g.reshape(L, S)[m]
    return slots, gw, sw


def _gather(slots, gw, vf, comm):
    """H v on the rank's slots, psum-reduced: (L, dim), the same on every
    rank."""
    vfp = torch.cat([vf, vf.new_zeros((1, vf.shape[1]))])
    return comm.psum(torch.einsum("ls,lsc->lc", gw, vfp[slots]))


def _spread(plan, sw, z, scale, nloc):
    """S z onto the rank's slots (nloc rows), through the stable-sort
    plan of its slot table."""
    dim = z.shape[1]
    vals = (sw[:, :, None] * z[:, None, :] * scale).reshape(-1, dim)
    vals = torch.cat([vals, vals.new_zeros((1, dim))])
    out = vals.new_zeros((nloc + 1, dim))
    out[plan.uniq] = vals[plan.slots].sum(dim=1)
    return out[:nloc]


def correction_local(slots, gw, sw, chol, scale, vel_l, body_vel, comm,
                     plan=None):
    """Rank-local velocity correction on the element-local state.

    vel_l: (E_loc, nn*dim) canonical local layout. Returns (corrected
    vel_l, flux) with flux the (L, dim) virtual flux, the same on every
    rank after the psum. `plan` is `spread_plan(slots)` when the caller
    keeps it."""
    dim = body_vel.shape[1]
    vf = vel_l.reshape(-1, dim)
    plan = spread_plan(slots) if plan is None else plan
    hv = _gather(slots, gw, vf, comm)
    flux = torch.cholesky_solve(body_vel - hv, chol, upper=False)
    corr = _spread(plan, sw, flux, scale, vf.shape[0])
    return (vf + corr).reshape(vel_l.shape), flux


def correction_cg_local(slots, gw, sw, scale, vel_l, body_vel, flux0, comm,
                        rtol=1e-10, maxiter=200, plan=None):
    """Matrix-free rank-local velocity correction (moving bodies): solve
    C z = v_body - H v by CG, where each application of C = H S is one
    local spread, one local gather and one psum; the dense core is never
    formed, so a moving body's per-step tables need no host assembly.

    The flux iterates are replicated (L, dim) tensors: the psum inside H
    gives every rank the same Krylov scalars, so the CG's dots are local
    and its stopping check agrees on every rank. Returns (corrected vel_l,
    flux, (iters, relres)), the last two 0-d tensors."""
    from pynama_tpu_torch.solver.cg import pcg

    dim = body_vel.shape[1]
    vf = vel_l.reshape(-1, dim)
    nloc = vf.shape[0]
    plan = spread_plan(slots) if plan is None else plan

    def S(z):
        return _spread(plan, sw, z, scale, nloc)

    # Jacobi diag(C)[l] = scale * sum_k w_lk^2: each of a node's `mult`
    # slots contributes (w/mult)*w, summed over the ranks by the psum
    d = comm.psum((gw * sw).sum(dim=1))[:, None] * scale
    rhs = body_vel - _gather(slots, gw, vf, comm)
    res = pcg(lambda z: _gather(slots, gw, S(z), comm), rhs, flux0,
              M_inv=lambda r: r / d, rtol=rtol, maxiter=maxiter)
    relres = res.residual / (torch.sqrt((rhs * rhs).sum()) + 1e-300)
    return (vf + S(res.x)).reshape(vel_l.shape), res.x, \
        (res.iters, relres)
