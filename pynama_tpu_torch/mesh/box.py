"""Structured box spectral-element mesh (host numpy, setup only).

Carried over from pynama_tpu/mesh/box.py. Because the mesh is a tensor
product, global node numbering is the lexicographic numbering of the global
GLL grid (axis 0 slowest); everything is a static numpy index table computed
once at setup.

Border naming keeps the reference convention: left/right = x min/max,
down/up = y min/max, back/front = z min/max.

Left out until the IBM cases are ported: `node_separation` and
`nodes_over_line`.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
import itertools

import numpy as np

from pynama_tpu_torch.basis.quadrature import lobatto_points

SIDE_NORMAL_AXIS = {"left": 0, "right": 0, "down": 1, "up": 1,
                    "back": 2, "front": 2}
SIDE_IS_MAX = {"left": False, "right": True, "down": False, "up": True,
               "back": False, "front": True}


def border_names(dim: int) -> list[str]:
    return (["down", "right", "up", "left"] if dim == 2
            else ["back", "front", "down", "up", "right", "left"])


def build_incidence(cell_nodes: np.ndarray, n_nodes: int) -> np.ndarray:
    """(n_nodes, max_fanin) indices into the flattened (n_cells*nnode_el)
    element-slot array, padded with n_cells*nnode_el (a zero slot).

    Column 0 is each node's lowest flat slot (a stable argsort), the
    representative slot the FDM preconditioner's gather path reads.
    """
    n_cells, nnode_el = cell_nodes.shape
    flat = cell_nodes.ravel()
    order = np.argsort(flat, kind="stable")
    sorted_nodes = flat[order]
    counts = np.bincount(sorted_nodes, minlength=n_nodes)
    kmax = int(counts.max())
    pad = n_cells * nnode_el
    inc = np.full((n_nodes, kmax), pad, dtype=np.int32)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    for k in range(kmax):
        mask = counts > k
        inc[mask, k] = order[starts[mask] + k]
    return inc


@dataclasses.dataclass(frozen=True)
class BoxMesh:
    ngl: int
    nelem: tuple[int, ...]
    lower: tuple[float, ...]
    upper: tuple[float, ...]

    @staticmethod
    def create(ngl, nelem, lower, upper) -> "BoxMesh":
        nelem = tuple(int(n) for n in nelem)
        lower = tuple(float(x) for x in lower)
        upper = tuple(float(x) for x in upper)
        if not len(nelem) == len(lower) == len(upper):
            raise ValueError("nelem, lower and upper must have one entry "
                             "per dimension")
        if len(nelem) not in (2, 3):
            raise ValueError("box meshes are 2D or 3D")
        return BoxMesh(ngl=int(ngl), nelem=nelem, lower=lower, upper=upper)

    # -- sizes ------------------------------------------------------------
    @property
    def dim(self) -> int:
        return len(self.nelem)

    @property
    def dim_w(self) -> int:
        return 1 if self.dim == 2 else 3

    @property
    def dim_s(self) -> int:
        return 3 if self.dim == 2 else 6

    @property
    def nnode_el(self) -> int:
        return self.ngl**self.dim

    @property
    def npts(self) -> tuple[int, ...]:
        return tuple(n * (self.ngl - 1) + 1 for n in self.nelem)

    @property
    def n_nodes(self) -> int:
        return int(np.prod(self.npts))

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.nelem))

    # -- coordinates ------------------------------------------------------
    @cached_property
    def axis_coords(self) -> list[np.ndarray]:
        """Per-axis 1D global node coordinates (GLL-spaced within elements)."""
        gll, _ = lobatto_points(self.ngl)
        out = []
        for d in range(self.dim):
            edges = np.linspace(self.lower[d], self.upper[d],
                                self.nelem[d] + 1)
            pts = []
            for e in range(self.nelem[d]):
                x0, x1 = edges[e], edges[e + 1]
                loc = x0 + (gll + 1.0) * 0.5 * (x1 - x0)
                pts.append(loc[:-1] if e < self.nelem[d] - 1 else loc)
            out.append(np.concatenate(pts))
        return out

    @cached_property
    def coords(self) -> np.ndarray:
        """Global node coordinates, (n_nodes, dim), lexicographic order."""
        grids = np.meshgrid(*self.axis_coords, indexing="ij")
        return np.stack([g.ravel() for g in grids], axis=-1)

    # -- connectivity -----------------------------------------------------
    @cached_property
    def cell_nodes(self) -> np.ndarray:
        """(n_cells, nnode_el) global node ids per cell, tensor order."""
        N = self.ngl
        strides = np.array([int(np.prod(self.npts[d + 1:]))
                            for d in range(self.dim)])
        # per-axis global grid index of each element's local nodes
        ax_idx = [np.arange(ne)[:, None] * (N - 1) + np.arange(N)[None, :]
                  for ne in self.nelem]  # (ne_d, N)
        if self.dim == 2:
            gx = ax_idx[0][:, None, :, None]  # (ex,1,N,1)
            gy = ax_idx[1][None, :, None, :]  # (1,ey,1,N)
            ids = gx * strides[0] + gy * strides[1]
            return ids.reshape(self.n_cells, self.nnode_el).astype(np.int32)
        gx = ax_idx[0][:, None, None, :, None, None]
        gy = ax_idx[1][None, :, None, None, :, None]
        gz = ax_idx[2][None, None, :, None, None, :]
        ids = gx * strides[0] + gy * strides[1] + gz * strides[2]
        return ids.reshape(self.n_cells, self.nnode_el).astype(np.int32)

    @cached_property
    def cell_corners(self) -> np.ndarray:
        """(n_cells, 2**dim, dim) physical corner coordinates, tensor order."""
        edges = [np.linspace(self.lower[d], self.upper[d], self.nelem[d] + 1)
                 for d in range(self.dim)]
        cells = list(itertools.product(*[range(n) for n in self.nelem]))
        out = np.empty((self.n_cells, 2**self.dim, self.dim))
        corner_t = list(itertools.product((0, 1), repeat=self.dim))
        for ci, ct in enumerate(cells):
            for ki, kt in enumerate(corner_t):
                for d in range(self.dim):
                    out[ci, ki, d] = edges[d][ct[d] + kt[d]]
        return out

    @property
    def is_uniform(self) -> bool:
        """True when all elements are congruent (always for linspace boxes)."""
        return True

    @property
    def is_box(self) -> bool:
        return True

    @property
    def border_name_list(self) -> list:
        return border_names(self.dim)

    def border_normal_axis(self, name: str) -> int:
        return SIDE_NORMAL_AXIS[name]

    @cached_property
    def incidence(self) -> np.ndarray:
        """(n_nodes, max_fanin) element-slot fan-in table (<= 2**dim for a
        structured mesh); see `build_incidence`."""
        return build_incidence(self.cell_nodes, self.n_nodes)

    # -- boundaries -------------------------------------------------------
    @cached_property
    def node_grid_index(self) -> list[np.ndarray]:
        """Per-axis grid index of every node, each (n_nodes,)."""
        idx = np.arange(self.n_nodes)
        out = []
        for d in range(self.dim):
            stride = int(np.prod(self.npts[d + 1:]))
            out.append((idx // stride) % self.npts[d])
        return out

    def border_nodes(self, side: str) -> np.ndarray:
        """Sorted global node ids on one border face (corners included)."""
        ax = SIDE_NORMAL_AXIS[side]
        if ax >= self.dim:
            raise ValueError(f"side {side} undefined in {self.dim}D")
        val = self.npts[ax] - 1 if SIDE_IS_MAX[side] else 0
        return np.where(self.node_grid_index[ax] == val)[0].astype(np.int32)

    @cached_property
    def all_border_nodes(self) -> np.ndarray:
        mask = np.zeros(self.n_nodes, dtype=bool)
        for s in border_names(self.dim):
            mask[self.border_nodes(s)] = True
        return np.where(mask)[0].astype(np.int32)
