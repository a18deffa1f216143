"""Matrix-free global application of element-local operators.

Port of pynama_tpu/ops/apply.py, the global-layout path (the direct
solver, the global CG/GMRES, `Problem.operator` and the verification
sweeps). A global sparse matvec becomes

    gather  : xe = x[cell_nodes]                    (E, nnode, din)
    compute : ze = xe @ K_e^T                       batched dense matmul
    reduce  : y[n] = sum_k ze_flat[incidence[n,k]]  fixed-fanin gather-sum

The reduce step is a gather over a padded index table followed by a sum,
not a scatter-add: a node belongs to at most 2**dim elements, so each node
sums its own slots in a fixed order. `index_add_` would be an atomic
scatter on CUDA whose order changes between runs, which would break
GPU-against-CPU parity.

Every index tensor here is int64 (PyTorch's indexing type). Matmuls run in
full float32 or float64 (`config.py` pins TF32 off).

The numpy twins (`fanin_sum_np`, `assembled_diagonal_np`, `assemble_dense`)
are the JAX package's, carried over: setup-time host code.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import pynama_tpu_torch.config  # noqa: F401 -- full-f32 matmul pins


@dataclasses.dataclass(frozen=True)
class ElementOp:
    """A global operator defined by element-local dense blocks.

    mat layout is interleaved: row = a*dout + c, col = b*din + e with a,b
    local tensor-ordered nodes.
    """
    #: (nd_out, nd_in) shared, or (E, nd_out, nd_in) per-element
    mat: torch.Tensor
    #: (E, nnode) global node ids, int64
    cell_nodes: torch.Tensor
    #: (n_nodes, kmax) indices into E*nnode (pad = E*nnode), int64
    incidence: torch.Tensor
    #: components per node of input / output
    din: int
    dout: int
    n_nodes: int

    @property
    def n_cells(self) -> int:
        return self.cell_nodes.shape[0]

    @property
    def nnode_el(self) -> int:
        return self.cell_nodes.shape[1]


def make_element_op(mat, cell_nodes, incidence, din, dout, n_nodes, *,
                    device, dtype) -> ElementOp:
    """ElementOp on `device`: `mat` cast to `dtype`, the index arrays to
    int64. Tensors already of that kind on that device are shared, not
    copied (one cell_nodes/incidence pair serves every operator)."""
    def idx(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=torch.int64)
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    if isinstance(mat, torch.Tensor):
        mat = mat.to(device=device, dtype=dtype)
    else:
        mat = torch.as_tensor(np.asarray(mat), dtype=dtype, device=device)
    return ElementOp(mat=mat, cell_nodes=idx(cell_nodes),
                     incidence=idx(incidence), din=int(din), dout=int(dout),
                     n_nodes=int(n_nodes))


def element_gather(op: ElementOp, x: torch.Tensor) -> torch.Tensor:
    """x (n_nodes, din) -> (E, nnode*din) element-local interleaved dofs."""
    xe = x[op.cell_nodes]  # (E, nnode, din)
    return xe.reshape(op.n_cells, op.nnode_el * op.din)


def fanin_sum(op: ElementOp, ze: torch.Tensor) -> torch.Tensor:
    """ze (E, nnode*dout) element contributions -> (n_nodes, dout) sums: a
    gather over the padded incidence table, then a sum (deterministic)."""
    zf = ze.reshape(op.n_cells * op.nnode_el, op.dout)
    zf = torch.cat([zf, zf.new_zeros((1, op.dout))])
    return zf[op.incidence].sum(dim=1)


def apply_op(op: ElementOp, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the globally-assembled operator A, matrix-free."""
    xe = element_gather(op, x)
    if op.mat.ndim == 2:
        ze = xe @ op.mat.T
    else:
        ze = torch.einsum("eij,ej->ei", op.mat, xe)
    return fanin_sum(op, ze)


def assembled_diagonal(op: ElementOp) -> torch.Tensor:
    """Diagonal of the assembled square operator, (n_nodes, dout)."""
    if op.din != op.dout:
        raise ValueError("assembled_diagonal needs a square operator")
    if op.mat.ndim == 2:
        de = torch.diagonal(op.mat)[None, :].expand(op.n_cells, -1)
    else:
        de = torch.diagonal(op.mat, dim1=-2, dim2=-1)
    return fanin_sum(op, de)


def fanin_sum_np(cell_nodes: np.ndarray, ze: np.ndarray, dout: int,
                 n_nodes: int) -> np.ndarray:
    """Host (numpy) twin of fanin_sum for setup-time data."""
    cn = np.asarray(cell_nodes)
    zf = np.asarray(ze).reshape(cn.size, dout)
    out = np.zeros((n_nodes, dout), dtype=zf.dtype)
    np.add.at(out, cn.ravel(), zf)
    return out


def assembled_diagonal_np(mat: np.ndarray, cell_nodes: np.ndarray,
                          n_nodes: int) -> np.ndarray:
    """Host twin of assembled_diagonal (square operator, din == dout)."""
    mats = np.asarray(mat)
    nnc = mats.shape[-1]
    cn = np.asarray(cell_nodes)
    dout = nnc // cn.shape[1]
    if mats.ndim == 2:
        de = np.tile(np.diagonal(mats)[None, :], (cn.shape[0], 1))
    else:
        de = np.diagonal(mats, axis1=-2, axis2=-1)
    return fanin_sum_np(cell_nodes, de, dout, n_nodes)


def assemble_dense(mat: np.ndarray, cell_nodes: np.ndarray, din: int,
                   dout: int, n_nodes: int) -> np.ndarray:
    """Host-side dense assembly of the global operator (numpy float64).

    Used by the direct (Cholesky) solve path and differential tests — the
    moral equivalent of the reference's assembled AIJ matrices.
    """
    E, nnode = cell_nodes.shape
    A = np.zeros((n_nodes * dout, n_nodes * din))
    mats = np.broadcast_to(mat, (E,) + mat.shape[-2:])
    rows_l = np.repeat(np.arange(nnode), dout)
    rows_c = np.tile(np.arange(dout), nnode)
    cols_l = np.repeat(np.arange(nnode), din)
    cols_c = np.tile(np.arange(din), nnode)
    for e in range(E):
        gr = cell_nodes[e][rows_l] * dout + rows_c
        gc = cell_nodes[e][cols_l] * din + cols_c
        np.add.at(A, (gr[:, None], gc[None, :]), mats[e])
    return A
