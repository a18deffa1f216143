"""Lagrange interpolation basis values/derivatives at arbitrary 1D points.

Parity with reference `src/domain/elements/element.py:13-45` (`interpFun1D`),
implemented with the standard product formulas, vectorized.
"""
from __future__ import annotations

import numpy as np


def lagrange_basis(nodes: np.ndarray, eval_points: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Values and first derivatives of the Lagrange basis on `nodes`.

    Returns (h, dh), each of shape (n_eval, n_nodes):
      h[q, j]  = l_j(x_q)
      dh[q, j] = l'_j(x_q)
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    xq = np.asarray(eval_points, dtype=np.float64)
    n = nodes.size
    m = xq.size

    # denominator: prod_{k != j} (x_j - x_k)
    diff_nodes = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff_nodes, 1.0)
    denom = np.prod(diff_nodes, axis=1)  # (n,)

    # numerator terms t[q, j, k] = x_q - x_k  (k-th factor of l_j)
    t = xq[:, None] - nodes[None, :]  # (m, n) of (x_q - x_k)

    h = np.empty((m, n))
    dh = np.empty((m, n))
    for j in range(n):
        factors = np.delete(t, j, axis=1)  # (m, n-1)
        h[:, j] = np.prod(factors, axis=1) / denom[j]
        # derivative: sum over dropped factor
        dsum = np.zeros(m)
        for k in range(n - 1):
            dsum += np.prod(np.delete(factors, k, axis=1), axis=1)
        dh[:, j] = dsum / denom[j]
    return h, dh
