"""Unstructured 2D quad spectral-element mesh (host numpy, setup only).

Carried over from pynama_tpu/mesh/unstructured.py. Global high-order nodes
are numbered entity by entity: vertices first, then (ngl-2) nodes per edge,
then (ngl-2)^2 per cell interior. Each cell's tensor-ordered node table is
assembled with orientation-consistent edge traversal: shared-edge nodes are
always stored low-vertex -> high-vertex, so adjacent cells agree with no
exchange between them.

Geometry is bilinear per cell (corner map); every element gets its own
dense KLE matrices through the batched path of `elements/kle.py`, and the
fan-in table `incidence` has whatever width the mesh demands (no 2**dim
cap). The edge table, the node table and the fan-in come from `native`
(g++ at first use, numpy without it).

3D unstructured (hex) meshes live in `mesh/unstructured3d.py` (HexMesh);
`pynama_tpu_torch.mesh.mesh_from_gmsh` dispatches on the file contents.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from pynama_tpu_torch import native
from pynama_tpu_torch.basis.quadrature import lobatto_points
from pynama_tpu_torch.mesh.gmsh import read_msh

#: tensor corner order [c00, c01, c10, c11] from gmsh CCW [v0, v1, v2, v3]
_CCW_TO_TENSOR = (0, 3, 1, 2)


@dataclasses.dataclass(frozen=True)
class UnstructuredMesh:
    ngl: int
    vertices: np.ndarray        # (V, 2) float64
    cells_ccw: np.ndarray       # (C, 4) int32, gmsh CCW corner order
    boundary_lines: dict        # name -> (B, 2) int32 vertex pairs

    # -------------------------------------------------------------- create
    @staticmethod
    def from_gmsh(path: str, ngl: int) -> "UnstructuredMesh":
        data = read_msh(path)
        if data.is_3d:
            raise ValueError(
                f"{path} contains hex volumes; use HexMesh.create or "
                "pynama_tpu_torch.mesh.mesh_from_gmsh (auto-dispatch)")
        return UnstructuredMesh.create(ngl, data.vertices, data.quads,
                                       data.lines)

    @staticmethod
    def create(ngl, vertices, cells_ccw, boundary_lines=None
               ) -> "UnstructuredMesh":
        vertices = np.asarray(vertices, dtype=np.float64)
        cells = np.asarray(cells_ccw, dtype=np.int32).copy()
        # canonicalize to positive orientation (CCW); a negative bilinear
        # Jacobian flips v1 <-> v3
        for c in range(len(cells)):
            v = vertices[cells[c]]
            area2 = 0.0
            for k in range(4):
                x0, y0 = v[k]
                x1, y1 = v[(k + 1) % 4]
                area2 += x0 * y1 - x1 * y0
            if area2 < 0:
                cells[c, 1], cells[c, 3] = cells[c, 3], cells[c, 1]
        if boundary_lines is None:
            boundary_lines = {}
        return UnstructuredMesh(ngl=int(ngl), vertices=vertices,
                                cells_ccw=cells,
                                boundary_lines=dict(boundary_lines))

    # ---------------------------------------------------------- dimensions
    @property
    def dim(self) -> int:
        return 2

    @property
    def dim_w(self) -> int:
        return 1

    @property
    def dim_s(self) -> int:
        return 3

    @property
    def nnode_el(self) -> int:
        return self.ngl ** 2

    @property
    def n_cells(self) -> int:
        return len(self.cells_ccw)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def is_uniform(self) -> bool:
        return False

    @property
    def is_box(self) -> bool:
        return False

    # ------------------------------------------------------------ entities
    @cached_property
    def cells_tensor(self) -> np.ndarray:
        """(C, 4) corner vertex ids in tensor order [c00, c01, c10, c11]."""
        return self.cells_ccw[:, _CCW_TO_TENSOR]

    @cached_property
    def _edge_table(self):
        """Unique edges as sorted vertex pairs.

        Returns (edges (E,2) with e[0] < e[1], edge_id {key: idx}).
        Per-cell edge traversal in tensor terms:
          row0 (a0=0):   c00 -> c01,  row1 (a0=N-1): c10 -> c11
          col0 (a1=0):   c00 -> c10,  col1 (a1=N-1): c01 -> c11
        """
        return native.unique_edges(self.cells_tensor)

    @property
    def edges(self) -> np.ndarray:
        return self._edge_table[0]

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def n_nodes(self) -> int:
        k = self.ngl - 2
        return self.n_vertices + self.n_edges * k + self.n_cells * k * k

    # ------------------------------------------------------------ node ids
    def _edge_nodes(self, e: int, reverse: bool) -> np.ndarray:
        """Global ids of edge e's (ngl-2) interior nodes, traversal order."""
        k = self.ngl - 2
        base = self.n_vertices + e * k
        ids = np.arange(base, base + k)
        return ids[::-1] if reverse else ids

    @cached_property
    def cell_nodes(self) -> np.ndarray:
        """(C, ngl^2) global node ids per cell, tensor order (a0 slowest)."""
        N = self.ngl
        k = N - 2
        ct = self.cells_tensor
        edges, cell_edges = self._edge_table
        fast = native.cell_nodes(ct, cell_edges, self.n_vertices,
                                 self.n_edges, N)
        if fast is not None:
            return fast
        int_base = self.n_vertices + self.n_edges * k
        out = np.empty((self.n_cells, N, N), dtype=np.int64)
        # traversal (start, end) per edge slot, grid placement
        slots = [((0, 1), (0, slice(1, N - 1))),       # row a0=0
                 ((2, 3), (N - 1, slice(1, N - 1))),   # row a0=N-1
                 ((0, 2), (slice(1, N - 1), 0)),       # col a1=0
                 ((1, 3), (slice(1, N - 1), N - 1))]   # col a1=N-1
        for c in range(self.n_cells):
            corners = ct[c]
            out[c, 0, 0] = corners[0]
            out[c, 0, N - 1] = corners[1]
            out[c, N - 1, 0] = corners[2]
            out[c, N - 1, N - 1] = corners[3]
            if k:
                for s, ((i0, i1), place) in enumerate(slots):
                    e = cell_edges[c, s]
                    reverse = corners[i0] > corners[i1]
                    out[c][place] = self._edge_nodes(e, reverse)
                ib = int_base + c * k * k
                out[c, 1:N - 1, 1:N - 1] = \
                    np.arange(ib, ib + k * k).reshape(k, k)
        return out.reshape(self.n_cells, self.nnode_el).astype(np.int32)

    @cached_property
    def cell_corners(self) -> np.ndarray:
        """(C, 4, 2) physical corner coordinates, tensor order."""
        return self.vertices[self.cells_tensor]

    @cached_property
    def coords(self) -> np.ndarray:
        """(n_nodes, 2) node coordinates: vertices as-is, edge nodes on the
        straight segment at interior GLL abscissae, interiors from the
        bilinear corner map."""
        N = self.ngl
        gll, _ = lobatto_points(N)
        t = (gll + 1.0) / 2.0                       # [0, 1]
        out = np.empty((self.n_nodes, 2))
        out[:self.n_vertices] = self.vertices
        k = N - 2
        if k:
            # edge nodes, stored low-vertex -> high-vertex
            e = self.edges
            a = self.vertices[e[:, 0]][:, None, :]   # (E,1,2)
            b = self.vertices[e[:, 1]][:, None, :]
            ti = t[1:-1][None, :, None]              # (1,k,1)
            out[self.n_vertices:self.n_vertices + self.n_edges * k] = \
                ((1 - ti) * a + ti * b).reshape(-1, 2)
            # interior nodes: bilinear map at interior GLL grid
            t0 = t[1:-1][:, None]                    # a0 (k,1)
            t1 = t[1:-1][None, :]                    # a1 (1,k)
            w00 = ((1 - t0) * (1 - t1)).ravel()
            w01 = ((1 - t0) * t1).ravel()
            w10 = (t0 * (1 - t1)).ravel()
            w11 = (t0 * t1).ravel()
            cc = self.cell_corners                   # (C,4,2)
            interior = (w00[None, :, None] * cc[:, None, 0]
                        + w01[None, :, None] * cc[:, None, 1]
                        + w10[None, :, None] * cc[:, None, 2]
                        + w11[None, :, None] * cc[:, None, 3])
            out[self.n_vertices + self.n_edges * k:] = interior.reshape(-1, 2)
        return out

    @cached_property
    def incidence(self) -> np.ndarray:
        """(n_nodes, max_fanin) indices into the flat (C*nnode_el) slot
        array, padded with C*nnode_el (same contract as BoxMesh.incidence,
        but fan-in is mesh-dependent: no 2**dim cap)."""
        return native.build_incidence(self.cell_nodes, self.n_nodes)

    # ----------------------------------------------------------- boundaries
    @property
    def border_name_list(self) -> list:
        return list(self.boundary_lines.keys())

    def _edge_id(self, u, v) -> int:
        key = (min(u, v), max(u, v))
        ids = self._edge_ids_by_key
        if key not in ids:
            raise ValueError(f"boundary line {key} is not a mesh edge")
        return ids[key]

    @cached_property
    def _edge_ids_by_key(self) -> dict:
        return {(int(a), int(b)): i
                for i, (a, b) in enumerate(self.edges)}

    def border_nodes(self, name: str) -> np.ndarray:
        """Sorted global node ids on one named boundary group."""
        if name not in self.boundary_lines:
            raise ValueError(f"unknown boundary group '{name}'; "
                             f"have {self.border_name_list}")
        k = self.ngl - 2
        ids = set()
        for u, v in self.boundary_lines[name]:
            ids.add(int(u))
            ids.add(int(v))
            if k:
                ids.update(self._edge_nodes(self._edge_id(u, v),
                                            False).tolist())
        return np.array(sorted(ids), dtype=np.int32)

    @cached_property
    def all_border_nodes(self) -> np.ndarray:
        mask = np.zeros(self.n_nodes, dtype=bool)
        for name in self.boundary_lines:
            mask[self.border_nodes(name)] = True
        return np.where(mask)[0].astype(np.int32)

    @cached_property
    def _edge_owner_cell(self) -> np.ndarray:
        """(E,) one owning cell per edge."""
        _, cell_edges = self._edge_table
        owner = np.full(self.n_edges, -1, dtype=np.int64)
        for c in range(self.n_cells):
            for s in range(4):
                owner[cell_edges[c, s]] = c
        return owner

    def border_outward_normals(self, name: str) -> np.ndarray:
        """(B, 2) unit outward normal per boundary line segment."""
        segs = self.boundary_lines[name]
        out = np.empty((len(segs), 2))
        centroids = self.cell_corners.mean(axis=1)
        for i, (u, v) in enumerate(segs):
            e = self._edge_id(u, v)
            d = self.vertices[v] - self.vertices[u]
            n = np.array([d[1], -d[0]])
            n /= np.linalg.norm(n)
            mid = 0.5 * (self.vertices[u] + self.vertices[v])
            if np.dot(n, centroids[self._edge_owner_cell[e]] - mid) > 0:
                n = -n
            out[i] = n
        return out

    def border_normal_axis(self, name: str):
        """Axis index if the group's outward normals are all +-e_a for one
        axis a, else None (no-slip walls need an axis-aligned normal)."""
        normals = self.border_outward_normals(name)
        ax = int(np.argmax(np.abs(normals[0])))
        aligned = (np.abs(np.abs(normals[:, ax]) - 1.0) < 1e-9).all()
        return ax if aligned else None

    # -------------------------------------------------------------- helpers
    def node_separation(self) -> float:
        """Min edge length / (ngl-1), the node spacing the IBM uses."""
        e = self.edges
        lengths = np.linalg.norm(self.vertices[e[:, 1]]
                                 - self.vertices[e[:, 0]], axis=1)
        return float(lengths.min()) / (self.ngl - 1)

    def nodes_over_line(self, line: str, val: float, tol: float = 1e-12):
        """Nodes with coordinate `line` == val, sorted by the other coord."""
        assert line in ("x", "y")
        dof, other = (0, 1) if line == "x" else (1, 0)
        c = self.coords
        nodes = np.where(np.abs(c[:, dof] - val) <= tol)[0]
        order = np.argsort(c[nodes, other])
        nodes = nodes[order]
        return nodes, c[nodes, other]
