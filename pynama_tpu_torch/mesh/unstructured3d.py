"""Unstructured 3D hexahedral spectral-element mesh (host numpy, setup only).

Carried over from pynama_tpu/mesh/unstructured3d.py. Node numbering is
entity-ordered (vertices, then (ngl-2) per edge, (ngl-2)^2 per face,
(ngl-2)^3 per cell) with orientation rules that make shared entities agree
between adjacent cells with no exchange between them:

  * edges: interior nodes stored from the LOW vertex id to the HIGH one;
  * faces: interior grid stored in the face's canonical frame — origin at
    the face's minimum vertex id, u axis toward the smaller of its two
    cycle-neighbors — and each cell maps its local (p,q) face grid into
    that frame through one of the 8 quad symmetries.

Index-level flips equal coordinate-level flips because GLL abscissae are
symmetric (t_{N-1-i} = 1 - t_i). Geometry is trilinear per cell; face/edge
node positions depend only on the shared corner set, so adjacent cells
place them identically.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from pynama_tpu_torch import native
from pynama_tpu_torch.basis.quadrature import lobatto_points

#: tensor corner order (a0 a1 a2, a2 fastest) from gmsh hex v0..v7
#: gmsh: v0..v3 bottom quad CCW, v4..v7 top quad above them
_HEX_TO_TENSOR = (0, 4, 3, 7, 1, 5, 2, 6)

#: 12 edges as (tensor corner a, tensor corner b), grouped by direction
_EDGES = (
    # along a2: (a0,a1) in {0,1}^2
    (0, 1), (2, 3), (4, 5), (6, 7),
    # along a1: (a0,a2) in {0,1}^2
    (0, 2), (1, 3), (4, 6), (5, 7),
    # along a0: (a1,a2) in {0,1}^2
    (0, 4), (1, 5), (2, 6), (3, 7),
)

#: 6 faces: (4 tensor corners at local (p,q) = (0,0),(1,0),(0,1),(1,1),
#:           axis, side) — p is the first (slower) local grid axis
_FACES = (
    ((0, 2, 1, 3), 0, 0),   # a0 = 0,   p=a1, q=a2
    ((4, 6, 5, 7), 0, 1),   # a0 = N-1
    ((0, 4, 1, 5), 1, 0),   # a1 = 0,   p=a0, q=a2
    ((2, 6, 3, 7), 1, 1),   # a1 = N-1
    ((0, 4, 2, 6), 2, 0),   # a2 = 0,   p=a0, q=a1
    ((1, 5, 3, 7), 2, 1),   # a2 = N-1
)


def _face_canonical(corners):
    """Canonical frame of a quad face given its 4 corner ids at local
    positions (0,0),(1,0),(0,1),(1,1).

    Returns (O, U, V, W): origin (min id), u-neighbor, v-neighbor,
    opposite — a pure function of the corner ID SET + adjacency, so both
    adjacent cells derive the same frame."""
    pos = {0: (0, 0), 1: (1, 0), 2: (0, 1), 3: (1, 1)}
    ids = list(corners)
    k0 = int(np.argmin(ids))
    p0 = pos[k0]
    # neighbors: Hamming distance 1 in position
    nb = [k for k in range(4)
          if (pos[k][0] != p0[0]) + (pos[k][1] != p0[1]) == 1]
    ku = nb[0] if ids[nb[0]] < ids[nb[1]] else nb[1]
    kv = nb[1] if ku == nb[0] else nb[0]
    kw = ({0, 1, 2, 3} - {k0, ku, kv}).pop()
    return k0, ku, kv, kw


def _face_index_map(corners, k):
    """Map a cell's local face-interior grid (ip, iq), each in 1..k, to the
    canonical storage index (iu-1)*k + (iv-1).

    Returns an (k, k) int array `m` with m[ip-1, iq-1] = canonical index.
    """
    pos = {0: (0, 0), 1: (1, 0), 2: (0, 1), 3: (1, 1)}
    k0, ku, kv, _ = _face_canonical(corners)
    p0 = np.array(pos[k0])
    du = np.array(pos[ku]) - p0          # unit step in local (p,q)
    dv = np.array(pos[kv]) - p0
    ip = np.arange(1, k + 1)[:, None]    # local p index
    iq = np.arange(1, k + 1)[None, :]    # local q index
    # local fractional index along p/q measured FROM the canonical origin
    lp = ip if p0[0] == 0 else k + 1 - ip
    lq = iq if p0[1] == 0 else k + 1 - iq
    # canonical u runs along du: pick lp if du is the p axis else lq
    iu = lp if du[0] != 0 else lq
    iv = lq if du[0] != 0 else lp
    return ((iu - 1) * k + (iv - 1)).astype(np.int64)


def _face_class_maps(k: int) -> np.ndarray:
    """(8, k, k) canonical-index maps, one per face symmetry class
    (min-corner position 0..3) x (u-neighbor = first/second of its two
    cycle neighbors). Built by realizing each class with synthetic ids."""
    nb_pairs = {0: (1, 2), 1: (0, 3), 2: (0, 3), 3: (1, 2)}
    maps = np.empty((8, k, k), dtype=np.int64)
    for k0 in range(4):
        for f in (0, 1):
            ids = [0, 0, 0, 0]
            ids[k0] = 0
            u = nb_pairs[k0][f]
            v = nb_pairs[k0][1 - f]
            w = ({0, 1, 2, 3} - {k0, u, v}).pop()
            ids[u], ids[v], ids[w] = 1, 2, 3
            maps[k0 * 2 + f] = _face_index_map(ids, k)
    return maps


@dataclasses.dataclass(frozen=True)
class HexMesh:
    ngl: int
    vertices: np.ndarray        # (V, 3)
    cells_gmsh: np.ndarray      # (C, 8) int32, gmsh hex corner order
    boundary_quads: dict        # name -> (B, 4) int32 vertex quadruples

    # -------------------------------------------------------------- create
    @staticmethod
    def create(ngl, vertices, cells_gmsh, boundary_quads=None) -> "HexMesh":
        vertices = np.asarray(vertices, dtype=np.float64)
        cells = np.asarray(cells_gmsh, dtype=np.int32).copy()
        # positive trilinear orientation at the centroid; a negative
        # Jacobian is fixed by swapping bottom and top gmsh faces
        for c in range(len(cells)):
            ct = cells[c][list(_HEX_TO_TENSOR)]
            v = vertices[ct].reshape(2, 2, 2, 3)
            e0 = v[1].mean((0, 1)) - v[0].mean((0, 1))
            e1 = v[:, 1].mean((0, 1)) - v[:, 0].mean((0, 1))
            e2 = v[:, :, 1].mean((0, 1)) - v[:, :, 0].mean((0, 1))
            if np.linalg.det(np.stack([e0, e1, e2], axis=1)) < 0:
                cells[c, :4], cells[c, 4:] = \
                    cells[c, 4:].copy(), cells[c, :4].copy()
        return HexMesh(ngl=int(ngl), vertices=vertices, cells_gmsh=cells,
                       boundary_quads=dict(boundary_quads or {}))

    # ---------------------------------------------------------- dimensions
    @property
    def dim(self):
        return 3

    @property
    def dim_w(self):
        return 3

    @property
    def dim_s(self):
        return 6

    @property
    def nnode_el(self):
        return self.ngl ** 3

    @property
    def n_cells(self):
        return len(self.cells_gmsh)

    @property
    def n_vertices(self):
        return len(self.vertices)

    @property
    def is_uniform(self):
        return False

    @property
    def is_box(self):
        return False

    # ------------------------------------------------------------ entities
    @cached_property
    def cells_tensor(self) -> np.ndarray:
        return self.cells_gmsh[:, list(_HEX_TO_TENSOR)]

    @cached_property
    def _edge_table(self):
        ct = self.cells_tensor
        pairs = np.concatenate([ct[:, [a, b]] for a, b in _EDGES], axis=0)
        keys = np.sort(pairs, axis=1)
        edges, inverse = np.unique(keys, axis=0, return_inverse=True)
        return (edges.astype(np.int32),
                inverse.reshape(len(_EDGES), self.n_cells).T)

    @cached_property
    def _face_table(self):
        ct = self.cells_tensor
        quads = np.concatenate([ct[:, list(f[0])] for f in _FACES], axis=0)
        keys = np.sort(quads, axis=1)
        faces, inverse = np.unique(keys, axis=0, return_inverse=True)
        return (faces.astype(np.int32),
                inverse.reshape(len(_FACES), self.n_cells).T)

    @property
    def edges(self):
        return self._edge_table[0]

    @property
    def n_edges(self):
        return len(self.edges)

    @property
    def n_faces(self):
        return len(self._face_table[0])

    @property
    def n_nodes(self):
        k = self.ngl - 2
        return (self.n_vertices + self.n_edges * k + self.n_faces * k * k
                + self.n_cells * k ** 3)

    # -------------------------------------------------------- entity nodes
    def _edge_nodes(self, e, reverse):
        k = self.ngl - 2
        base = self.n_vertices + e * k
        ids = np.arange(base, base + k)
        return ids[::-1] if reverse else ids

    def _face_base(self, fidx):
        k = self.ngl - 2
        return self.n_vertices + self.n_edges * k + fidx * k * k

    @cached_property
    def _face_corner_cycle(self):
        """(F, 4) face corner ids at canonical storage — kept as the
        LOCAL-position quadruple of the FIRST cell that touched the face
        (used to compute each cell's index map consistently: the canonical
        frame is position-independent, so any representative works)."""
        faces, cell_faces = self._face_table
        ct = self.cells_tensor
        rep = np.zeros((self.n_faces, 4), dtype=np.int64)
        done = np.zeros(self.n_faces, dtype=bool)
        for c in range(self.n_cells):
            for s, (loc, _, _) in enumerate(_FACES):
                fidx = cell_faces[c, s]
                if not done[fidx]:
                    rep[fidx] = ct[c, list(loc)]
                    done[fidx] = True
        return rep

    @cached_property
    def cell_nodes(self) -> np.ndarray:
        """(C, ngl^3) global node ids, tensor order (a0 slowest).

        Fully vectorized over cells: the face index map depends only on
        the face's symmetry class — (position of the min-id corner) x
        (which of its two neighbors is smaller) = 8 classes — so the 8
        (k, k) maps are precomputed and gathered per (cell, face-slot).
        """
        N = self.ngl
        k = N - 2
        C = self.n_cells
        ct = self.cells_tensor.astype(np.int64)
        edges, cell_edges = self._edge_table
        faces, cell_faces = self._face_table
        int_base = (self.n_vertices + self.n_edges * k
                    + self.n_faces * k * k)
        out = np.empty((C, N, N, N), dtype=np.int64)
        inner = slice(1, N - 1)
        lohi = (0, N - 1)

        # corners
        ci = 0
        for a0 in (0, 1):
            for a1 in (0, 1):
                for a2 in (0, 1):
                    out[:, lohi[a0], lohi[a1], lohi[a2]] = ct[:, ci]
                    ci += 1
        if not k:
            return out.reshape(C, self.nnode_el).astype(np.int32)

        # edges (vectorized over cells per slot)
        ar = np.arange(k)
        for i, (a, b) in enumerate(_EDGES):
            e = cell_edges[:, i].astype(np.int64)
            rev = ct[:, a] > ct[:, b]
            ids = (self.n_vertices + e[:, None] * k
                   + np.where(rev[:, None], k - 1 - ar, ar))
            if i < 4:
                a0, a1 = lohi[(a >> 2) & 1], lohi[(a >> 1) & 1]
                out[:, a0, a1, inner] = ids
            elif i < 8:
                a0, a2 = lohi[(a >> 2) & 1], lohi[a & 1]
                out[:, a0, inner, a2] = ids
            else:
                a1, a2 = lohi[(a >> 1) & 1], lohi[a & 1]
                out[:, inner, a1, a2] = ids

        # faces: 8 symmetry-class maps, gathered per cell
        class_maps = _face_class_maps(k)              # (8, k, k)
        nb_pairs = {0: (1, 2), 1: (0, 3), 2: (0, 3), 3: (1, 2)}
        for s, (loc, axis, side) in enumerate(_FACES):
            quad = ct[:, list(loc)]                   # (C, 4)
            fidx = cell_faces[:, s].astype(np.int64)
            k0 = np.argmin(quad, axis=1)
            nbA = np.array([nb_pairs[i][0] for i in range(4)])[k0]
            nbB = np.array([nb_pairs[i][1] for i in range(4)])[k0]
            u_first = quad[np.arange(C), nbA] < quad[np.arange(C), nbB]
            cls = k0 * 2 + (~u_first).astype(np.int64)
            ids = (self._face_base(0) + fidx[:, None, None] * k * k
                   + class_maps[cls])
            sl = [slice(None), inner, inner, inner]
            sl[1 + axis] = (0 if side == 0 else N - 1)
            out[tuple(sl)] = ids

        # interiors
        grid = np.arange(k ** 3).reshape(k, k, k)
        out[:, inner, inner, inner] = (
            int_base + np.arange(C)[:, None, None, None] * k ** 3 + grid)
        return out.reshape(C, self.nnode_el).astype(np.int32)

    @cached_property
    def cell_corners(self) -> np.ndarray:
        """(C, 8, 3) physical corner coordinates, tensor order."""
        return self.vertices[self.cells_tensor]

    @cached_property
    def coords(self) -> np.ndarray:
        N = self.ngl
        k = N - 2
        gll, _ = lobatto_points(N)
        t = (gll + 1.0) / 2.0
        out = np.empty((self.n_nodes, 3))
        out[:self.n_vertices] = self.vertices
        if not k:
            return out
        ti = t[1:-1]
        # edges: linear low-vertex -> high-vertex
        e = self.edges
        a = self.vertices[e[:, 0]][:, None, :]
        b = self.vertices[e[:, 1]][:, None, :]
        out[self.n_vertices:self.n_vertices + self.n_edges * k] = \
            ((1 - ti[None, :, None]) * a + ti[None, :, None] * b
             ).reshape(-1, 3)
        # faces: bilinear in the canonical (O, U, V, W) frame
        rep = self._face_corner_cycle
        fo = self._face_base(0)
        for fidx in range(self.n_faces):
            cyc = rep[fidx]
            k0, ku, kv, kw = _face_canonical(cyc)
            O, U = self.vertices[cyc[k0]], self.vertices[cyc[ku]]
            V, W = self.vertices[cyc[kv]], self.vertices[cyc[kw]]
            tu = ti[:, None, None]
            tv = ti[None, :, None]
            grid = ((1 - tu) * (1 - tv) * O + tu * (1 - tv) * U
                    + (1 - tu) * tv * V + tu * tv * W)
            out[fo + fidx * k * k: fo + (fidx + 1) * k * k] = \
                grid.reshape(-1, 3)
        # interiors: trilinear
        t0 = ti[:, None, None, None]
        t1 = ti[None, :, None, None]
        t2 = ti[None, None, :, None]
        cc = self.cell_corners.reshape(-1, 2, 2, 2, 3)
        w = [(1 - t0, t0), (1 - t1, t1), (1 - t2, t2)]
        grid = sum(w[0][i] * w[1][j] * w[2][l] * cc[:, None, None, None,
                                                    i, j, l]
                   for i in (0, 1) for j in (0, 1) for l in (0, 1))
        io = fo + self.n_faces * k * k
        out[io:] = grid.reshape(-1, 3)
        return out

    @cached_property
    def incidence(self) -> np.ndarray:
        return native.build_incidence(self.cell_nodes, self.n_nodes)

    # ----------------------------------------------------------- boundaries
    @property
    def border_name_list(self):
        return list(self.boundary_quads.keys())

    @cached_property
    def _face_ids_by_key(self):
        return {tuple(f): i for i, f in enumerate(self._face_table[0])}

    def border_nodes(self, name: str) -> np.ndarray:
        if name not in self.boundary_quads:
            raise ValueError(f"unknown boundary group '{name}'; "
                             f"have {self.border_name_list}")
        k = self.ngl - 2
        ids = set()
        ekeys = self._edge_ids_by_key
        for quad in self.boundary_quads[name]:
            q = [int(v) for v in quad]
            ids.update(q)
            if not k:
                continue
            # the quad's 4 edges (cycle order v0-v1-v2-v3)
            for u, v in ((q[0], q[1]), (q[1], q[2]), (q[2], q[3]),
                         (q[3], q[0])):
                key = (min(u, v), max(u, v))
                e = ekeys.get(key)
                if e is None:
                    raise ValueError(f"boundary quad edge {key} not in mesh")
                ids.update(self._edge_nodes(e, False).tolist())
            fkey = tuple(sorted(q))
            fidx = self._face_ids_by_key.get(fkey)
            if fidx is None:
                raise ValueError(f"boundary quad {fkey} is not a mesh face")
            base = self._face_base(fidx)
            ids.update(range(base, base + k * k))
        return np.array(sorted(ids), dtype=np.int32)

    @cached_property
    def _edge_ids_by_key(self):
        return {(int(a), int(b)): i for i, (a, b) in enumerate(self.edges)}

    @cached_property
    def _face_owner_cell(self):
        _, cell_faces = self._face_table
        owner = np.full(self.n_faces, -1, dtype=np.int64)
        for c in range(self.n_cells):
            for s in range(6):
                owner[cell_faces[c, s]] = c
        return owner

    def border_outward_normals(self, name: str) -> np.ndarray:
        quads = self.boundary_quads[name]
        out = np.empty((len(quads), 3))
        centroids = self.cell_corners.mean(axis=1)
        for i, q in enumerate(quads):
            q = [int(v) for v in q]
            fidx = self._face_ids_by_key[tuple(sorted(q))]
            p0, p1, p2 = (self.vertices[q[0]], self.vertices[q[1]],
                          self.vertices[q[3]])
            n = np.cross(p1 - p0, p2 - p0)
            n /= np.linalg.norm(n)
            mid = self.vertices[q].mean(axis=0)
            if np.dot(n, centroids[self._face_owner_cell[fidx]] - mid) > 0:
                n = -n
            out[i] = n
        return out

    def border_normal_axis(self, name: str):
        normals = self.border_outward_normals(name)
        ax = int(np.argmax(np.abs(normals[0])))
        aligned = (np.abs(np.abs(normals[:, ax]) - 1.0) < 1e-9).all()
        return ax if aligned else None

    @cached_property
    def all_border_nodes(self) -> np.ndarray:
        mask = np.zeros(self.n_nodes, dtype=bool)
        for name in self.boundary_quads:
            mask[self.border_nodes(name)] = True
        return np.where(mask)[0].astype(np.int32)

    # -------------------------------------------------------------- helpers
    def node_separation(self) -> float:
        e = self.edges
        lengths = np.linalg.norm(self.vertices[e[:, 1]]
                                 - self.vertices[e[:, 0]], axis=1)
        return float(lengths.min()) / (self.ngl - 1)
