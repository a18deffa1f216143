"""Element-local layout and its direct-stiffness summation.

Port of pynama_tpu/ops/local.py. The canonical state layout
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

On an unstructured mesh (gmsh quads and hexes) every element has its own
matrices, `emm` is the batched per-element product, and the DSS is a
fixed-fan-in gather (`_dss_gather`): each global node sums its slots
through the padded incidence table in a fixed order, and every slot then
reads its node's sum back, so duplicates are bitwise equal there too.

These are the plain PyTorch versions: `ops/fused.py` computes
``dss(layout, emm(t, matT))`` for box meshes in one hand-written CUDA
kernel on the GPU and uses these as its plain reference on the CPU.

Sharded runs (`parallel/`) pass a `comm` (`parallel/comm.py::SlabComm`,
the counterpart of the JAX package's `axis_name`): on a box mesh split into
axis-0 slabs the axis-0 pass also exchanges the outermost interface planes
with the neighbour ranks; on an unstructured mesh split into element ranges
each rank's fan-in is partial and one `psum` of the partition-interface
rows (`LocalLayout.iface`) completes it. `dss_overlapped` is the box-mesh
variant that posts the plane exchange before the axes-1..d-1 passes and
waits for it after them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch


def emm(t: torch.Tensor, matT: torch.Tensor) -> torch.Tensor:
    """t @ matT with a shared (nnc_in, nnc_out) element matrix, or the
    batched per-element form when matT is (E, nnc_in, nnc_out)
    (unstructured meshes: every element has its own geometry). Full f32:
    config.py pins TF32 off."""
    if matT.dim() == 2:
        return t @ matT
    return torch.einsum("ei,eio->eo", t, matT)


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


@functools.lru_cache(maxsize=64)
def make_perms(ngl: int, dim: int, ncomp: int, device) -> tuple:
    """`perm_arrays` as int64 tensors on `device`, made once per argument
    tuple (read-only, shared by every caller)."""
    return tuple(torch.as_tensor(p, device=device)
                 for p in perm_arrays(ngl, dim, ncomp))


# ------------------------------------------------------------------ layout
@dataclasses.dataclass(frozen=True)
class LocalLayout:
    """Hot-path tables for one (nelem, ngl, ncomp) local representation.

    Box meshes (structured) carry the per-axis column rotations `perms`;
    unstructured meshes carry `nelem = (n_cells,)`, no perms, the fan-in
    table `incidence` (n_nodes, kmax) into the E*nnode slots (pad =
    E*nnode) and `cell_nodes` (E, nnode), both int64, and their `mesh_dim`.
    """
    perms: tuple                 # dim (nnc,) int64 gather-index tensors
    inv_mult: torch.Tensor       # (E, nnc) 1/slot-multiplicity
    ngl: int
    nelem: tuple
    ncomp: int
    incidence: Optional[torch.Tensor] = None
    cell_nodes: Optional[torch.Tensor] = None
    structured: bool = True
    mesh_dim: int = 0
    #: sharded unstructured meshes: global node ids on the partition
    #: interface (nodes touched by the cells of two or more ranks). The
    #: cross-rank DSS sums only these rows, which is exact: every other
    #: row is complete on its one rank and no other rank's cells read it.
    #: None -> the whole node vector is summed.
    iface: Optional[torch.Tensor] = None

    @property
    def dim(self) -> int:
        return self.mesh_dim or len(self.nelem)

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.nelem))

    @property
    def nnode_el(self) -> int:
        return self.ngl ** self.dim

    @property
    def nnc(self) -> int:
        return self.nnode_el * self.ncomp

    @property
    def plane_cols(self) -> int:
        """Columns in one local axis-plane (a trailing block in axis-major
        order)."""
        return (self.nnode_el // self.ngl) * self.ncomp


def make_local_layout(mesh, ncomp: int, device, dtype) -> LocalLayout:
    cell_nodes = np.asarray(mesh.cell_nodes)
    counts = np.bincount(cell_nodes.ravel(), minlength=mesh.n_nodes)
    inv = 1.0 / counts[cell_nodes]                     # (E, nnode)
    inv_mult = torch.as_tensor(np.repeat(inv, ncomp, axis=1), dtype=dtype,
                               device=device)
    if getattr(mesh, "is_box", False):
        return LocalLayout(perms=make_perms(mesh.ngl, mesh.dim, ncomp,
                                            device),
                           inv_mult=inv_mult, ngl=mesh.ngl,
                           nelem=tuple(mesh.nelem), ncomp=int(ncomp))
    idx = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                    device=device)
    return LocalLayout(perms=(), inv_mult=inv_mult, ngl=mesh.ngl,
                       nelem=(int(mesh.n_cells),), ncomp=int(ncomp),
                       incidence=idx(mesh.incidence),
                       cell_nodes=idx(cell_nodes), structured=False,
                       mesh_dim=int(mesh.dim))


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
def _sharded(comm) -> bool:
    return comm is not None and comm.size > 1


def _dss_axis_major(t: torch.Tensor, nelem: tuple, axis: int, nnc: int,
                    plane: int, comm=None) -> torch.Tensor:
    """Interface-plane exchange along mesh `axis`, with t's columns in
    axis-major order: local plane 0 = first `plane` columns, plane N-1 =
    last `plane` columns. t: (E, nnc).

    With a `comm` of two or more ranks (axis-0 slabs), the axis-0 pass
    also sends this slab's outermost planes to the neighbour ranks and adds
    theirs: the plane exchange inside a distributed operator application."""
    ne = nelem[axis]
    exchange = axis == 0 and _sharded(comm)
    if ne == 1 and not exchange:
        return t
    lead = int(np.prod(nelem[:axis]))
    trail = int(np.prod(nelem[axis + 1:]))
    g = t.reshape(lead, ne, trail, nnc)
    out = g.clone()
    if ne > 1:
        out[:, 1:, :, :plane] += g[:, :-1, :, nnc - plane:]  # left nbr's last
        out[:, :-1, :, nnc - plane:] += g[:, 1:, :, :plane]  # right nbr's 1st
    if exchange:
        from_left, from_right = comm.exchange(out[0, 0, :, :plane],
                                              out[0, -1, :, nnc - plane:])
        out[0, 0, :, :plane] += from_left
        out[0, -1, :, nnc - plane:] += from_right
    return out.reshape(-1, nnc)


def dss_box(t: torch.Tensor, nelem: tuple, ngl: int, ncomp: int,
            perms: tuple, comm=None) -> torch.Tensor:
    """Full DSS of a canonical-order box-mesh local vector (of this rank's
    axis-0 slab, with the neighbours' planes added, when `comm` has two or
    more ranks)."""
    dim = len(nelem)
    nnc = ngl ** dim * ncomp
    plane = ngl ** (dim - 1) * ncomp
    for d in range(dim):
        t = _dss_axis_major(t, nelem, d, nnc, plane, comm)
        t = t[:, perms[d]]          # rotate to the next axis-major order
    return t


def _dss_gather(layout: LocalLayout, t: torch.Tensor,
                comm=None) -> torch.Tensor:
    """General-mesh DSS: the fan-in of every global node as one gather over
    the padded incidence table (the pad slot reads a zero row) and a sum
    over it, then every slot reads its node's sum back. Deterministic (no
    `index_add_`), so every duplicated slot comes out bitwise equal.

    With a `comm` of two or more ranks (element ranges), the table holds
    this rank's slots only, so the fan-in is partial; one psum of the
    `iface` rows (of every row when iface is None) completes it, the same
    bits on every rank."""
    E, nn, c = layout.n_cells, layout.nnode_el, layout.ncomp
    zf = torch.cat([t.reshape(E * nn, c), t.new_zeros((1, c))])
    g = zf[layout.incidence].sum(dim=1)               # (n_nodes, c)
    if _sharded(comm):
        if layout.iface is not None:
            g[layout.iface] = comm.psum(g[layout.iface])
        else:
            g = comm.psum(g)
    return g[layout.cell_nodes].reshape(E, nn * c)


def dss(layout: LocalLayout, t: torch.Tensor, comm=None) -> torch.Tensor:
    """Full direct-stiffness summation: canonical-order in/out, every
    duplicated slot assembled (over every rank's slab when `comm` has two
    or more ranks)."""
    if not layout.structured:
        return _dss_gather(layout, t, comm)
    return dss_box(t, layout.nelem, layout.ngl, layout.ncomp, layout.perms,
                   comm)


def make_plane_layout(layout: LocalLayout) -> LocalLayout:
    """LocalLayout of the (dim-1)-dimensional axis-0 interface-plane
    sub-mesh (elements (ne1[, ne2]), same ngl/ncomp): the working set of
    the overlapped DSS's plane passes. inv_mult is not read by the DSS and
    is left empty."""
    sub_nelem = tuple(layout.nelem[1:])
    perms = make_perms(layout.ngl, len(sub_nelem), layout.ncomp,
                       layout.inv_mult.device)
    return LocalLayout(perms=perms, inv_mult=layout.inv_mult.new_zeros(0),
                       ngl=layout.ngl, nelem=sub_nelem, ncomp=layout.ncomp)


def dss_overlapped(layout: LocalLayout, plane_layout: LocalLayout,
                   t: torch.Tensor, comm) -> torch.Tensor:
    """The sharded box-mesh DSS with the plane exchange overlapped against
    the bulk passes.

    The per-axis passes commute (each is a linear sum over a disjoint index
    dimension), and a neighbour needs only this slab's boundary plane with
    the other axes' passes applied. So: run the two boundary planes through
    the axes-1..d-1 plane DSS, post the exchange (`comm.exchange_start`),
    run the whole volume's axes-1..d-1 passes and the axis-0 internal adds
    while the transfers fly, then wait and add the received planes. Equal
    to `dss(layout, t, comm)` up to the order of the summation."""
    nnc, plane = layout.nnc, layout.plane_cols
    nelem, dim = layout.nelem, layout.dim
    ne0 = nelem[0]
    trail = int(np.prod(nelem[1:]))
    g = t.reshape(ne0, trail, nnc)

    def plane_dss(p):                    # (trail, plane) sub-mesh DSS
        sub = plane_layout
        return dss_box(p.contiguous(), sub.nelem, sub.ngl, sub.ncomp,
                       sub.perms)

    pending = comm.exchange_start(plane_dss(g[0, :, :plane]),
                                  plane_dss(g[-1, :, nnc - plane:]))
    # bulk: axes 1..dim-1 over the whole slab, then axis-0 internal adds
    u = t[:, layout.perms[0]]                    # rotate to axis-1-major
    for d in range(1, dim):
        u = _dss_axis_major(u, nelem, d, nnc, plane)
        u = u[:, layout.perms[d]]                # ...back to canonical
    u = _dss_axis_major(u, nelem, 0, nnc, plane)
    from_left, from_right = pending.wait()
    gu = u.reshape(ne0, trail, nnc)
    gu[0, :, :plane] += from_left
    gu[-1, :, nnc - plane:] += from_right
    return gu.reshape(-1, nnc)


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


# ------------------------------------------------------------------ LocalOp
@dataclasses.dataclass(frozen=True)
class LocalOp:
    """Element operator executing in the local layout.

    matT is the element matrix transposed ((nnode*din, nnode*dout), or one
    per element, (E, nnode*din, nnode*dout)), rows and columns in canonical
    tensor order (the convention of ops/apply.py's ElementOp)."""
    matT: torch.Tensor
    layout_out: LocalLayout


def make_local_op(mat, layout_out: LocalLayout, *, device,
                  dtype) -> LocalOp:
    matT = torch.as_tensor(np.swapaxes(np.asarray(mat), -1, -2),
                           dtype=dtype, device=device).contiguous()
    return LocalOp(matT=matT, layout_out=layout_out)


def apply_local_op(op: LocalOp, t: torch.Tensor) -> torch.Tensor:
    """y_local = DSS(x_local @ K^T): assembled operator application."""
    return dss(op.layout_out, emm(t, op.matT))


def local_diagonal(op: LocalOp) -> torch.Tensor:
    """Assembled diagonal in local layout, (E, nnc)."""
    lo = op.layout_out
    d = torch.diagonal(op.matT, dim1=-2, dim2=-1)
    de = d.expand(lo.n_cells, -1) if d.dim() == 1 else d
    return dss(lo, de.contiguous())
