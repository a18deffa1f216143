"""Operator memory / size reporting (the printMatsInfo analog,
reference `src/matrices/mat_fs.py:122-129`).

The reference reports assembled-AIJ nnz and bytes; the engine is
matrix-free, so the honest analog is the bytes of each operator bundle
(the tensors and arrays of its dataclass tree) plus the *effective*
assembled nnz its application replaces.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def pytree_nbytes(tree) -> int:
    """Total bytes of every tensor and ndarray in a tree of dataclasses,
    tuples, lists and dicts (host or device), each counted once."""
    seen = set()

    def walk(x) -> int:
        if isinstance(x, (torch.Tensor, np.ndarray)):
            if id(x) in seen:
                return 0
            seen.add(id(x))
            return int(x.nbytes)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return sum(walk(getattr(x, f.name))
                       for f in dataclasses.fields(x))
        if isinstance(x, (tuple, list)):
            return sum(walk(v) for v in x)
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        return 0

    return walk(tree)


def ops_info(problem) -> dict:
    """Size report for a set-up Problem: per-operator bytes and the
    assembled-equivalent nnz of K (what a PETSc AIJ build would store)."""
    mesh = problem.mesh
    nnc = mesh.nnode_el * mesh.dim
    em_bytes = pytree_nbytes(problem.kle) if problem.kle is not None else 0
    eng_bytes = pytree_nbytes(problem.engine_ops) \
        if getattr(problem, "engine_ops", None) is not None else 0
    # effective nnz: every element contributes a dense nnc x nnc block;
    # shared nodes merge, so the true assembled count is <= E * nnc^2
    nnz_upper = mesh.n_cells * nnc * nnc
    return {
        "n_nodes": int(mesh.n_nodes),
        "n_cells": int(mesh.n_cells),
        "dofs": int(mesh.n_nodes * mesh.dim),
        "kle_solver_bytes": em_bytes,
        "engine_bytes": eng_bytes,
        "assembled_nnz_upper_bound": int(nnz_upper),
        "matrix_free_bytes_per_assembled_nnz":
            round((em_bytes + eng_bytes) / max(nnz_upper, 1), 4),
    }


def format_ops_info(info: dict) -> str:
    mb = 1.0 / (1024 * 1024)
    return (f"operators: {info['dofs']} dofs, "
            f"solver {info['kle_solver_bytes']*mb:.1f} MiB, "
            f"engine {info['engine_bytes']*mb:.1f} MiB, "
            f"assembled-equivalent nnz <= "
            f"{info['assembled_nnz_upper_bound']:,} "
            f"({info['matrix_free_bytes_per_assembled_nnz']} B/nnz "
            f"matrix-free)")
