"""Sparse matrix containers as frozen dataclasses of tensors.

Port of pynama_tpu/sparse/formats.py. Four formats:

  COO — assembly interchange (duplicate-friendly, reducible by row)
  CSR — classic compressed rows (interchange + host-side ops)
  ELL — padded fixed-width rows: SpMV is a dense gather + multiply + row
        sum with static shapes. Spectral-element stencils have near-uniform
        row widths, so padding waste is small.
  BSR — block CSR with dim x dim dense blocks (interleaved velocity dofs).

Index tensors are int64 (PyTorch's indexing type; the JAX package uses
int32); `shape` and `blocksize` are host ints.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class COO:
    data: torch.Tensor      # (nnz,)
    row: torch.Tensor       # (nnz,) int64
    col: torch.Tensor       # (nnz,) int64
    shape: tuple[int, int]

    @property
    def nnz(self):
        return self.data.shape[0]


@dataclasses.dataclass(frozen=True)
class CSR:
    data: torch.Tensor      # (nnz,)
    indices: torch.Tensor   # (nnz,) int64 column ids
    indptr: torch.Tensor    # (nrows+1,) int64
    shape: tuple[int, int]

    @property
    def nnz(self):
        return self.data.shape[0]


@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded rows: data/cols are (nrows, width); padding entries have
    col == ncols, pointing at a zero slot, and data 0."""
    data: torch.Tensor      # (nrows, width)
    cols: torch.Tensor      # (nrows, width) int64, pad = ncols
    shape: tuple[int, int]

    @property
    def width(self):
        return self.data.shape[1]


@dataclasses.dataclass(frozen=True)
class BSR:
    data: torch.Tensor      # (nblocks, bs, bs)
    indices: torch.Tensor   # (nblocks,) int64 block-column ids
    indptr: torch.Tensor    # (n_brows+1,) int64
    shape: tuple[int, int]
    blocksize: int

    @property
    def nnz(self):
        return self.data.shape[0] * self.blocksize * self.blocksize
