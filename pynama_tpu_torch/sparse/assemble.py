"""Sparse assembly: element-local dense blocks -> global sparse formats.

Port of pynama_tpu/sparse/assemble.py. The symbolic pass stays host numpy
(setup time): element contributions become one COO triplet list whose
duplicate (row, col) pairs are summed after a sort; the conversions between
formats read their input back to the host and return tensors on the
input's device. `assemble_coo` and `assemble_from_elements` take the device
explicitly.
"""
from __future__ import annotations

import numpy as np
import torch

from pynama_tpu_torch.sparse.formats import BSR, COO, CSR, ELL


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def element_triplets(cell_nodes: np.ndarray, din: int, dout: int):
    """Global (row, col) ids for every entry of every element block.

    Returns (rows, cols) each of shape (E, nd_out, nd_in) — the symbolic
    structure of the assembly, independent of values.
    """
    E, nnode = cell_nodes.shape
    rl = np.repeat(np.arange(nnode), dout)
    rc = np.tile(np.arange(dout), nnode)
    cl = np.repeat(np.arange(nnode), din)
    cc = np.tile(np.arange(din), nnode)
    grow = cell_nodes[:, rl] * dout + rc      # (E, nd_out)
    gcol = cell_nodes[:, cl] * din + cc       # (E, nd_in)
    rows = np.broadcast_to(grow[:, :, None],
                           (E, grow.shape[1], gcol.shape[1]))
    cols = np.broadcast_to(gcol[:, None, :],
                           (E, grow.shape[1], gcol.shape[1]))
    return rows, cols


def assemble_coo(mats: np.ndarray, cell_nodes: np.ndarray, din: int,
                 dout: int, n_nodes: int, dedup: bool = True, *,
                 device) -> COO:
    """Assemble element matrices (shared or per-element) into COO (float64
    values on `device`)."""
    mats = _np(mats)
    cell_nodes = _np(cell_nodes)
    E = cell_nodes.shape[0]
    rows, cols = element_triplets(cell_nodes, din, dout)
    vals = np.broadcast_to(mats, (E,) + mats.shape[-2:])
    r = rows.ravel()
    c = cols.ravel()
    v = vals.reshape(-1).astype(np.float64)
    shape = (n_nodes * dout, n_nodes * din)
    if dedup:
        key = r.astype(np.int64) * shape[1] + c
        order = np.argsort(key, kind="stable")
        key_s, v = key[order], v[order]
        uniq, inv = np.unique(key_s, return_inverse=True)
        vsum = np.zeros(len(uniq))
        np.add.at(vsum, inv, v)
        r = uniq // shape[1]
        c = uniq % shape[1]
        v = vsum
    return COO(data=torch.as_tensor(v, device=device), row=_idx(r, device),
               col=_idx(c, device), shape=shape)


def coo_to_csr(coo: COO) -> CSR:
    dev = coo.data.device
    r, c, v = _np(coo.row), _np(coo.col), _np(coo.data)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    indptr = np.zeros(coo.shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, r + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(data=torch.as_tensor(v, device=dev), indices=_idx(c, dev),
               indptr=_idx(indptr, dev), shape=coo.shape)


def csr_to_ell(csr: CSR, width: int | None = None,
               pad_to: int | None = None) -> ELL:
    """CSR -> padded ELL. Padding columns point at the virtual zero column
    `ncols` (spmv_ell pads x with one zero row)."""
    dev = csr.data.device
    indptr, indices, data = _np(csr.indptr), _np(csr.indices), _np(csr.data)
    nrows, ncols = csr.shape
    counts = np.diff(indptr)
    w = int(counts.max()) if width is None else width
    if pad_to is not None:
        w = -(-w // pad_to) * pad_to
    ell_d = np.zeros((nrows, w), dtype=data.dtype)
    ell_c = np.full((nrows, w), ncols, dtype=np.int64)
    for k in range(w):
        mask = counts > k
        src = indptr[:-1][mask] + k
        ell_d[mask, k] = data[src]
        ell_c[mask, k] = indices[src]
    return ELL(data=torch.as_tensor(ell_d, device=dev),
               cols=_idx(ell_c, dev), shape=csr.shape)


def csr_to_bsr(csr: CSR, bs: int) -> BSR:
    """CSR -> block-CSR with dense bs x bs blocks (zero-filled)."""
    dev = csr.data.device
    indptr, indices, data = _np(csr.indptr), _np(csr.indices), _np(csr.data)
    nrows, ncols = csr.shape
    if nrows % bs or ncols % bs:
        raise ValueError(f"shape {csr.shape} is not a multiple of the "
                         f"block size {bs}")
    nbr = nrows // bs
    # symbolic: block columns present in each block row
    bindptr = [0]
    bindices = []
    blocks = []
    for br in range(nbr):
        bcols = {}
        for r in range(br * bs, (br + 1) * bs):
            for k in range(indptr[r], indptr[r + 1]):
                bc = indices[k] // bs
                if bc not in bcols:
                    bcols[bc] = np.zeros((bs, bs), dtype=data.dtype)
                bcols[bc][r - br * bs, indices[k] - bc * bs] = data[k]
        for bc in sorted(bcols):
            bindices.append(bc)
            blocks.append(bcols[bc])
        bindptr.append(len(bindices))
    return BSR(data=torch.as_tensor(np.stack(blocks), device=dev),
               indices=_idx(bindices, dev), indptr=_idx(bindptr, dev),
               shape=csr.shape, blocksize=bs)


def assemble_from_elements(mats, cell_nodes, din, dout, n_nodes,
                           fmt: str = "ell", dtype=None, pad_to=8, *,
                           device):
    """One-call element->global assembly into the requested format, on
    `device`; values cast to `dtype` when given (float64 otherwise)."""
    coo = assemble_coo(mats, cell_nodes, din, dout, n_nodes, device=device)
    csr = coo_to_csr(coo)
    if dtype is not None:
        csr = CSR(data=csr.data.to(dtype), indices=csr.indices,
                  indptr=csr.indptr, shape=csr.shape)
    if fmt == "csr":
        return csr
    if fmt == "ell":
        return csr_to_ell(csr, pad_to=pad_to)
    if fmt == "bsr":
        return csr_to_bsr(csr, bs=dout)
    if fmt == "coo":
        return coo
    raise ValueError(f"unknown format {fmt}")
