"""Operations and bytes of one application of the KLE operator K on a hex
mesh whose elements each have their own geometry, counted from the
application's shape alone (E elements, ngl, dim, dtype), whatever
implements it: the count behind the measured package's chip_smoke.py
phase 14 (a) `bound_us` (`_sumfact_cost`), copied here so that the
yardstick does not move with the program.

The work is the sum-factorized product: the two reference-gradient
matmuls and their two transposed scatters over the full (ngl^dim points)
and reduced ((ngl-1)^dim points) quadrature families, and the dim x dim
geometry contractions at each point; the element vector is read once and
written once, the geometric factors (full family w|J| J^-1 J^-T, reduced
J^-1 and w|J|), the shared derivative tables and the two column gathers
read once. The bound is `counts.bound_s`: the larger of the operations
over the peak rate and the bytes over the memory rate.
"""
from __future__ import annotations

from counts import ITEM_BYTES, bound_s

INDEX_BYTES = 8


def apply_k_cost(E: int, ngl: int, dim: int,
                 dtype: str) -> tuple[float, float]:
    """(flops, bytes) of one element product of K over E elements."""
    nn = ngl ** dim
    nqf, nqr = ngl ** dim, (ngl - 1) ** dim
    flops = 2 * (2 * E * dim * nn * dim * (nqf + nqr)) \
        + 2 * dim * dim * E * dim * (nqf + 2 * nqr)
    eb = ITEM_BYTES[dtype]
    geometry = E * (dim * dim * nqf + dim * dim * nqr + nqr)
    tables = nn * dim * (nqf + nqr)
    vectors = 2 * E * dim * nn
    gathers = 2 * dim * nn * INDEX_BYTES
    return float(flops), float((geometry + tables + vectors) * eb + gathers)


def apply_k_bound_s(E: int, ngl: int, dim: int, dtype: str) -> float:
    return bound_s(*apply_k_cost(E, ngl, dim, dtype), dtype)[0]
