"""Sparse x sparse products (SpGEMM) — the PETSc MatMatMult analog.

Carried over from pynama_tpu/sparse/spgemm.py. The reference's only
sparse-sparse product is the IBM normal system A = H . S at setup; SpGEMM
is a setup-time host operation: output sparsity is data-dependent. Pure
numpy — expand the row-by-row products through indptr arithmetic, then
coalesce duplicates with a lexsort. The result is a CSR on the device of
A's tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from pynama_tpu_torch.sparse.formats import CSR, COO


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _to_host_csr(A):
    if isinstance(A, CSR):
        return _host(A.indptr), _host(A.indices), _host(A.data), A.shape
    if isinstance(A, COO):
        order = np.lexsort((_host(A.col), _host(A.row)))
        row = _host(A.row)[order]
        col = _host(A.col)[order]
        dat = _host(A.data)[order]
        indptr = np.zeros(A.shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, row + 1, 1)
        return np.cumsum(indptr), col, dat, A.shape
    raise TypeError(f"unsupported sparse type {type(A)}")


def spgemm(A, B) -> CSR:
    """C = A @ B for CSR/COO inputs; returns a coalesced, sorted CSR."""
    ap, ai, ad, ashape = _to_host_csr(A)
    bp, bi, bd, bshape = _to_host_csr(B)
    if ashape[1] != bshape[0]:
        raise ValueError(f"shape mismatch {ashape} x {bshape}")

    # expand: for each A-nnz (r, k, a), pair with all B-nnz of row k
    counts = (bp[ai + 1] - bp[ai]).astype(np.int64)     # B-row sizes per A-nnz
    total = int(counts.sum())
    rep = np.repeat(np.arange(len(ai)), counts)          # A-nnz index per pair
    # position within each B row
    offs = np.arange(total) - np.repeat(
        np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
    bpos = bp[ai][rep] + offs
    arow = np.repeat(np.arange(ashape[0]), ap[1:] - ap[:-1])
    rows = arow[rep]
    cols = bi[bpos]
    vals = ad[rep] * bd[bpos]

    # coalesce duplicates
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    new = np.ones(total, dtype=bool)
    if total:
        new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    group = np.cumsum(new) - 1
    nnz = int(new.sum())
    out_vals = np.zeros(nnz, dtype=vals.dtype)
    np.add.at(out_vals, group, vals)
    out_rows = rows[new]
    out_cols = cols[new]
    indptr = np.zeros(ashape[0] + 1, dtype=np.int64)
    np.add.at(indptr, out_rows + 1, 1)
    dev = A.data.device
    return CSR(data=torch.as_tensor(out_vals, device=dev),
               indices=torch.as_tensor(out_cols.astype(np.int64),
                                       device=dev),
               indptr=torch.as_tensor(np.cumsum(indptr), device=dev),
               shape=(ashape[0], bshape[1]))
