"""Sparse matrix-vector products (the PETSc MatMult replacement).

Port of pynama_tpu/sparse/spmv.py. ELL: y[r] = sum_k data[r,k] *
x[cols[r,k]] is a gather, a multiply and a row sum with static shapes, and
deterministic. CSR, COO and BSR reduce their products by row with
`index_add_`, which on CUDA is an atomic scatter-add whose summation order
changes from run to run: their results are not bitwise reproducible on a
GPU. None of them is on a transient's path (the engine and the global
`ElementOp` path never assemble); they serve the sparse library surface
and differential tests.

x may be (ncols,) or (ncols, m) (the multi-vector case is SpMM).
"""
from __future__ import annotations

import torch

from pynama_tpu_torch.sparse.formats import BSR, COO, CSR, ELL


def _row_ids(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Row id of every stored entry, from the row pointers."""
    nrows = indptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(nrows, device=indptr.device), torch.diff(indptr),
        output_size=nnz)


def _sum_rows(vals: torch.Tensor, rows: torch.Tensor,
              nrows: int) -> torch.Tensor:
    """out[r] = sum of vals[i] over rows[i] == r (atomic on CUDA)."""
    out = vals.new_zeros((nrows,) + vals.shape[1:])
    return out.index_add_(0, rows, vals)


def spmv_ell(A: ELL, x: torch.Tensor) -> torch.Tensor:
    """x: (ncols,) or (ncols, m). Returns (nrows,) or (nrows, m)."""
    squeeze = x.ndim == 1
    xm = x[:, None] if squeeze else x
    xp = torch.cat([xm, xm.new_zeros((1, xm.shape[1]))])
    gathered = xp[A.cols]                      # (nrows, width, m)
    y = (A.data[:, :, None] * gathered).sum(dim=1)
    return y[:, 0] if squeeze else y


def spmv_csr(A: CSR, x: torch.Tensor) -> torch.Tensor:
    data = A.data if x.ndim == 1 else A.data[:, None]
    vals = data * x[A.indices]
    return _sum_rows(vals, _row_ids(A.indptr, A.nnz), A.shape[0])


def spmv_coo(A: COO, x: torch.Tensor) -> torch.Tensor:
    data = A.data if x.ndim == 1 else A.data[:, None]
    return _sum_rows(data * x[A.col], A.row, A.shape[0])


def spmv_bsr(A: BSR, x: torch.Tensor) -> torch.Tensor:
    bs = A.blocksize
    xb = x.reshape(-1, bs)
    gathered = xb[A.indices]                   # (nblocks, bs)
    prod = (A.data * gathered[:, None, :]).sum(dim=2)
    nbr = A.shape[0] // bs
    yb = _sum_rows(prod, _row_ids(A.indptr, A.data.shape[0]), nbr)
    return yb.reshape(-1)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    if isinstance(A, ELL):
        return spmv_ell(A, x)
    if isinstance(A, CSR):
        return spmv_csr(A, x)
    if isinstance(A, COO):
        return spmv_coo(A, x)
    if isinstance(A, BSR):
        return spmv_bsr(A, x)
    raise TypeError(f"unsupported sparse type {type(A)}")
