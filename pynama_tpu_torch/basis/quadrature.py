"""1D quadrature rules on [-1, 1].

Functional parity with reference `src/domain/elements/utilities.py:43-92`
(`gaussPoints`, `lobattoPoints`), implemented via numpy's Legendre machinery:
Gauss-Legendre through `leggauss`, Gauss-Lobatto-Legendre as the roots of
(1-x^2) P'_{N-1}(x) with weights 2 / (N(N-1) P_{N-1}(x_i)^2).
"""
from __future__ import annotations

import numpy as np
from numpy.polynomial import legendre as npleg


def gauss_points(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes and weights, symmetrized to exact +-pairs."""
    x, w = npleg.leggauss(n)
    # enforce exact symmetry (the reference symmetrizes too,
    # utilities.py:58-60)
    x = (x - x[::-1]) / 2.0
    w = (w + w[::-1]) / 2.0
    return x, w


def lobatto_points(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Lobatto-Legendre nodes and weights (n >= 2).

    Interior nodes are the roots of P'_{n-1}; endpoints are -1, 1.
    """
    if n < 2:
        raise ValueError("GLL rule needs at least 2 points")
    # coefficients of P_{n-1} in the Legendre basis
    cN = np.zeros(n)
    cN[-1] = 1.0
    dcN = npleg.legder(cN)
    interior = npleg.legroots(dcN) if n > 2 else np.zeros((0,))
    x = np.concatenate(([-1.0], np.sort(np.real(interior)), [1.0]))
    # one Newton polish for the interior roots (legroots is already accurate;
    # this pins them to ~1 ulp)
    for _ in range(2):
        dP = npleg.legval(x[1:-1], dcN)
        d2P = npleg.legval(x[1:-1], npleg.legder(dcN))
        x[1:-1] -= dP / d2P
    Pn1 = npleg.legval(x, cN)
    w = 2.0 / (n * (n - 1) * Pn1**2)
    x = (x - x[::-1]) / 2.0
    w = (w + w[::-1]) / 2.0
    return x, w
