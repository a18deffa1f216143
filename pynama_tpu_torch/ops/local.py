"""Element-local layout and its direct-stiffness summation (structured half).

Port of pynama_tpu/ops/local.py for box meshes. The canonical state layout
for every solver field is the *local vector* ``(n_cells, nnode_el * ncomp)``:
each element owns a private copy of its nodes, columns in tensor order (axis
0 slowest) with interleaved components, ``col = node * ncomp + comp``. A
global sparse operator application becomes

    compute : z = x_local @ K_e^T     one dense (E, nnc_in) @ (nnc_in, nnc_out)
    DSS     : per-axis interface-plane adds, with column rotations between

Direct stiffness summation (DSS) gives every duplicated node slot the sum of
all of its copies. It runs axis by axis; each pass adds the neighbour
element's opposite plane, and columns are permuted to that axis's "major"
order first so the plane is a contiguous trailing block. Because each pass
adds one partner value to one slot and float addition is commutative, every
duplicate slot ends up with a bitwise-identical value (the "consistent
fields" contract of engine/local_engine.py).

These are the plain PyTorch versions: `ops/fused.py` computes
``dss(layout, emm(t, matT))`` in one hand-written CUDA kernel on the GPU
and uses these as its plain reference on the CPU.

Left out until their ROADMAP items: the gather DSS of unstructured meshes
(`_dss_gather`), `dss_overlapped` and the sharded (`axis_name`) branches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def emm(t: torch.Tensor, matT: torch.Tensor) -> torch.Tensor:
    """t @ matT with a shared (nnc_in, nnc_out) element matrix (full f32:
    config.py pins TF32 off)."""
    return t @ matT


# --------------------------------------------------------------- orderings
def _axis_major_order(dim: int, axis: int) -> tuple:
    """Local-axis permutation putting `axis` slowest (most significant)."""
    rest = [d for d in range(dim) if d != axis]
    return (axis, *rest)


def _local_col_index(ngl: int, dim: int, ncomp: int,
                     order: tuple) -> np.ndarray:
    """For each column of the `order`-major layout, the canonical column
    holding that dof (canonical column = node * ncomp + comp, node in tensor
    order with axis 0 slowest)."""
    N = ngl
    shape = (N,) * dim + (ncomp,)
    canon = np.arange(N**dim * ncomp).reshape(shape)
    permuted = np.transpose(canon, tuple(order) + (dim,))
    return permuted.reshape(-1)


def _perm_index(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Gather index g moving a row vector from layout `src` to layout
    `dst`: t_dst = t_src[:, g]."""
    n = src.size
    inv_src = np.empty(n, dtype=np.int64)
    inv_src[src] = np.arange(n)
    return inv_src[dst]


def perm_arrays(ngl: int, dim: int, ncomp: int) -> list:
    """perms[d] maps axis-d-major -> axis-(d+1 mod dim)-major columns;
    applying them in sequence after the per-axis DSS passes rotates the
    layout through all axis-major orders and back to canonical."""
    orders = [_axis_major_order(dim, d) for d in range(dim)]
    cols = [_local_col_index(ngl, dim, ncomp, o) for o in orders]
    return [_perm_index(cols[d], cols[(d + 1) % dim]) for d in range(dim)]


def make_perms(ngl: int, dim: int, ncomp: int, device) -> tuple:
    """`perm_arrays` as int64 tensors on `device`."""
    return tuple(torch.as_tensor(p, device=device)
                 for p in perm_arrays(ngl, dim, ncomp))


# ------------------------------------------------------------------ layout
@dataclasses.dataclass(frozen=True)
class LocalLayout:
    """Hot-path tables for one (nelem, ngl, ncomp) local representation."""
    perms: tuple                 # dim (nnc,) int64 gather-index tensors
    inv_mult: torch.Tensor       # (E, nnc) 1/slot-multiplicity
    ngl: int
    nelem: tuple
    ncomp: int


def make_local_layout(mesh, ncomp: int, device, dtype) -> LocalLayout:
    if not getattr(mesh, "is_box", False):
        raise NotImplementedError("unstructured meshes are not ported yet "
                                  "(ROADMAP Queue A item 12)")
    cell_nodes = np.asarray(mesh.cell_nodes)
    counts = np.bincount(cell_nodes.ravel(), minlength=mesh.n_nodes)
    inv = 1.0 / counts[cell_nodes]                     # (E, nnode)
    inv_mult = torch.as_tensor(np.repeat(inv, ncomp, axis=1), dtype=dtype,
                               device=device)
    return LocalLayout(perms=make_perms(mesh.ngl, mesh.dim, ncomp, device),
                       inv_mult=inv_mult, ngl=mesh.ngl,
                       nelem=tuple(mesh.nelem), ncomp=int(ncomp))


# -------------------------------------------------------- global <-> local
def to_local(mesh, x_global) -> np.ndarray:
    """(n_nodes, ncomp) -> (E, nnode*ncomp) canonical-order local vector.

    Setup/IO only (host-side gather)."""
    xg = np.asarray(x_global)
    E, nn = mesh.cell_nodes.shape
    return xg[np.asarray(mesh.cell_nodes)].reshape(E, nn * xg.shape[-1])


def to_global(mesh, t_local, ncomp: int) -> np.ndarray:
    """(E, nnode*ncomp) consistent local vector -> (n_nodes, ncomp)."""
    E, nn = mesh.cell_nodes.shape
    t = np.asarray(t_local).reshape(E * nn, ncomp)
    out = np.zeros((mesh.n_nodes, ncomp), dtype=t.dtype)
    out[np.asarray(mesh.cell_nodes).reshape(-1)] = t
    return out


# ---------------------------------------------------------------- DSS core
def _dss_axis_major(t: torch.Tensor, nelem: tuple, axis: int, nnc: int,
                    plane: int) -> torch.Tensor:
    """Interface-plane exchange along mesh `axis`, with t's columns in
    axis-major order: local plane 0 = first `plane` columns, plane N-1 =
    last `plane` columns. t: (E, nnc)."""
    ne = nelem[axis]
    if ne == 1:
        return t
    lead = int(np.prod(nelem[:axis]))
    trail = int(np.prod(nelem[axis + 1:]))
    g = t.reshape(lead, ne, trail, nnc)
    out = g.clone()
    out[:, 1:, :, :plane] += g[:, :-1, :, nnc - plane:]   # left nbr's last
    out[:, :-1, :, nnc - plane:] += g[:, 1:, :, :plane]   # right nbr's first
    return out.reshape(-1, nnc)


def dss_box(t: torch.Tensor, nelem: tuple, ngl: int, ncomp: int,
            perms: tuple) -> torch.Tensor:
    """Full DSS of a canonical-order box-mesh local vector."""
    dim = len(nelem)
    nnc = ngl ** dim * ncomp
    plane = ngl ** (dim - 1) * ncomp
    for d in range(dim):
        t = _dss_axis_major(t, nelem, d, nnc, plane)
        t = t[:, perms[d]]          # rotate to the next axis-major order
    return t


def dss(layout: LocalLayout, t: torch.Tensor) -> torch.Tensor:
    """Full direct-stiffness summation: canonical-order in/out, every
    duplicated slot assembled."""
    return dss_box(t, layout.nelem, layout.ngl, layout.ncomp, layout.perms)


def local_dot(layout: LocalLayout, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """Global inner product of two consistent local vectors."""
    return (a * b * layout.inv_mult).sum()


def dss_np(mesh, t: np.ndarray, ncomp: int) -> np.ndarray:
    """Host (numpy) DSS for setup-time data: assemble into global dofs and
    gather back. Semantically identical to `dss`."""
    cn = np.asarray(mesh.cell_nodes)
    gid = (np.repeat(cn.ravel(), ncomp) * ncomp
           + np.tile(np.arange(ncomp), cn.size))
    acc = np.zeros(mesh.n_nodes * ncomp, dtype=np.asarray(t).dtype)
    np.add.at(acc, gid, np.asarray(t).ravel())
    return acc[gid].reshape(np.asarray(t).shape)
