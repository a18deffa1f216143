"""Tensor-product spectral-element basis tables.

Replaces reference `src/domain/elements/spectral.py:42-90` (setUpSpectralMats*)
with a plain tensor ordering: local node a = (i_0, ..., i_{d-1}) flattens
C-style with axis 0 slowest, matching the global lexicographic node numbering
of the structured mesh (pynama_tpu_torch.mesh.box). The reference instead
permutes to DMPlex entity order (corners->edges->faces->interior); the two
layouts are equal up to a symmetric permutation.

Three quadrature families, as in the reference (`spectral.py:43-46`):
  * full:     Gauss(ngl) if ngl <= 3 else GLL(ngl)   (stiffness/Rw/Rd)
  * reduced:  Gauss(ngl-1)                           (div/curl penalties)
  * operator: GLL(ngl) nodal                         (SrT/DivSrT/Curl/weights)
Geometry uses the 2-node (bi/tri-linear corner) basis evaluated at each
family's points (`HCoo*`, spectral.py:57-64).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from pynama_tpu_torch.basis.lagrange import lagrange_basis
from pynama_tpu_torch.basis.quadrature import gauss_points, lobatto_points


@dataclasses.dataclass(frozen=True)
class Basis1D:
    nodes: np.ndarray
    weights: np.ndarray


@dataclasses.dataclass(frozen=True)
class QuadFamily:
    """Basis tables at one quadrature family, tensor-ordered."""
    #: quadrature point coordinates, (nq, dim)
    points: np.ndarray
    #: tensor-product weights, (nq,)
    weights: np.ndarray
    #: shape function values, (nq, nnode)
    H: np.ndarray
    #: reference-coordinate derivatives, (nq, dim, nnode)
    D: np.ndarray
    #: corner (geometry) shape functions, (nq, 2**dim)
    HCoo: np.ndarray
    #: corner shape derivative, (nq, dim, 2**dim)
    DCoo: np.ndarray


@dataclasses.dataclass(frozen=True)
class TensorBasis:
    dim: int
    ngl: int
    nodes1d: np.ndarray
    weights1d: np.ndarray
    full: QuadFamily
    reduced: QuadFamily
    operator: QuadFamily

    @property
    def nnode(self) -> int:
        return self.ngl**self.dim

    @property
    def dim_w(self) -> int:
        return 1 if self.dim == 2 else 3

    @property
    def dim_s(self) -> int:
        return 3 if self.dim == 2 else 6


def _tensor_family(dim: int, nodes1d: np.ndarray, corner1d: np.ndarray,
                   q1d: np.ndarray, w1d: np.ndarray) -> QuadFamily:
    h, dh = lagrange_basis(nodes1d, q1d)
    hc, dhc = lagrange_basis(corner1d, q1d)
    nq1 = q1d.size

    def build(hv, dhv, nn1):
        # tensor product over dim axes, axis 0 slowest
        qs = list(itertools.product(range(nq1), repeat=dim))
        ns = list(itertools.product(range(nn1), repeat=dim))
        H = np.empty((len(qs), len(ns)))
        D = np.empty((len(qs), dim, len(ns)))
        for qi, qt in enumerate(qs):
            for ai, at in enumerate(ns):
                vals = [hv[qt[d], at[d]] for d in range(dim)]
                H[qi, ai] = np.prod(vals)
                for dd in range(dim):
                    dvals = list(vals)
                    dvals[dd] = dhv[qt[dd], at[dd]]
                    D[qi, dd, ai] = np.prod(dvals)
        return H, D

    H, D = build(h, dh, nodes1d.size)
    HCoo, DCoo = build(hc, dhc, corner1d.size)

    pts = np.array(list(itertools.product(q1d, repeat=dim)))
    w = np.array([np.prod([w1d[i] for i in t])
                  for t in itertools.product(range(nq1), repeat=dim)])
    return QuadFamily(points=pts, weights=w, H=H, D=D, HCoo=HCoo, DCoo=DCoo)


def make_tensor_basis(ngl: int, dim: int) -> TensorBasis:
    if dim not in (2, 3):
        raise ValueError("dim must be 2 or 3")
    nodes1d, opw1d = lobatto_points(ngl)
    if ngl <= 3:
        fullq, fullw = gauss_points(ngl)
    else:
        fullq, fullw = lobatto_points(ngl)
    redq, redw = gauss_points(ngl - 1)
    corner1d, _ = lobatto_points(2)

    return TensorBasis(
        dim=dim, ngl=ngl, nodes1d=nodes1d, weights1d=opw1d,
        full=_tensor_family(dim, nodes1d, corner1d, fullq, fullw),
        reduced=_tensor_family(dim, nodes1d, corner1d, redq, redw),
        operator=_tensor_family(dim, nodes1d, corner1d, nodes1d, opw1d),
    )
