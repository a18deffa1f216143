"""The reference's set-up, host numpy float64: GLL basis, box mesh, element
matrices and operators, boundary masks and values.

A frozen copy of the plain set-up the measured package carries over from
the original solver (its basis/, mesh/box.py, elements/kle.py and
bc/conditions.py), cut to what a box-mesh cavity with constant wall values
needs: one element geometry shared by every element, constant no-slip or
free-slip sides. It imports nothing of the measured package, so a change
there cannot move the reference with it.

Layouts: local node a = (i_0, ..., i_{d-1}) in C order (axis 0 slowest),
global nodes numbered lexicographically on the GLL grid, dofs interleaved
(dof = node * ncomp + comp). Sides: left/right = x min/max, down/up = y
min/max, back/front = z min/max, applied in the order the config gives.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
from numpy.polynomial import legendre as npleg

ALPHA_W = 1.0e2   # curl penalty
ALPHA_D = 1.0e3   # divergence penalty

SIDE_AXIS = {"left": 0, "right": 0, "down": 1, "up": 1, "back": 2, "front": 2}
SIDE_MAX = {"left": False, "right": True, "down": False, "up": True,
            "back": False, "front": True}


# ---------------------------------------------------------------- quadrature
def gauss_points(n):
    x, w = npleg.leggauss(n)
    return (x - x[::-1]) / 2.0, (w + w[::-1]) / 2.0


def lobatto_points(n):
    c = np.zeros(n)
    c[-1] = 1.0
    dc = npleg.legder(c)
    inner = npleg.legroots(dc) if n > 2 else np.zeros((0,))
    x = np.concatenate(([-1.0], np.sort(np.real(inner)), [1.0]))
    for _ in range(2):
        x[1:-1] -= npleg.legval(x[1:-1], dc) / npleg.legval(
            x[1:-1], npleg.legder(dc))
    w = 2.0 / (n * (n - 1) * npleg.legval(x, c) ** 2)
    return (x - x[::-1]) / 2.0, (w + w[::-1]) / 2.0


def lagrange(nodes, pts):
    """(h, dh): values and derivatives of the Lagrange basis on `nodes` at
    `pts`, each (len(pts), len(nodes))."""
    n = nodes.size
    den = np.prod(np.where(np.eye(n, dtype=bool), 1.0,
                           nodes[:, None] - nodes[None, :]), axis=1)
    t = pts[:, None] - nodes[None, :]
    h = np.empty((pts.size, n))
    dh = np.empty((pts.size, n))
    for j in range(n):
        f = np.delete(t, j, axis=1)
        h[:, j] = np.prod(f, axis=1) / den[j]
        dh[:, j] = sum(np.prod(np.delete(f, k, axis=1), axis=1)
                       for k in range(n - 1)) / den[j]
    return h, dh


@dataclasses.dataclass(frozen=True)
class Family:
    """Tensor-ordered basis tables at one quadrature family."""
    w: np.ndarray      # (nq,) weights
    H: np.ndarray      # (nq, nn) shape values
    D: np.ndarray      # (nq, dim, nn) reference derivatives
    DC: np.ndarray     # (nq, dim, 2**dim) corner-basis derivatives


def _family(dim, nodes, q, w):
    def tensor(hv, dhv, m):
        qs = list(itertools.product(range(q.size), repeat=dim))
        ns = list(itertools.product(range(m), repeat=dim))
        H = np.empty((len(qs), len(ns)))
        D = np.empty((len(qs), dim, len(ns)))
        for qi, qt in enumerate(qs):
            for ai, at in enumerate(ns):
                v = [hv[qt[d], at[d]] for d in range(dim)]
                H[qi, ai] = np.prod(v)
                for dd in range(dim):
                    dv = list(v)
                    dv[dd] = dhv[qt[dd], at[dd]]
                    D[qi, dd, ai] = np.prod(dv)
        return H, D

    H, D = tensor(*lagrange(nodes, q), nodes.size)
    _, DC = tensor(*lagrange(np.array([-1.0, 1.0]), q), 2)
    ww = np.array([np.prod([w[i] for i in t])
                   for t in itertools.product(range(q.size), repeat=dim)])
    return Family(w=ww, H=H, D=D, DC=DC)


def _geometry(fam, corners):
    """(Hxy (nq, dim, nn) physical derivatives, wdet (nq,) w * det J)."""
    J = np.einsum("qra,ap->qrp", fam.DC, corners)
    Hxy = np.einsum("qpr,qra->qpa", np.linalg.inv(J), fam.D)
    return Hxy, fam.w * np.linalg.det(J)


def _eps(i, j, k):
    return ((i - j) * (j - k) * (k - i)) / 2.0


def _tensors(dim):
    """Index tensors: curl of v Tc[w,c,d], curl of w Tw[c,e,d], strain
    Ts[s,c,d], divergence of the strain Td[c,s,d]."""
    if dim == 2:
        Tc = np.zeros((1, 2, 2))
        Tc[0, 1, 0], Tc[0, 0, 1] = 1.0, -1.0
        Tw = np.zeros((2, 1, 2))
        Tw[0, 0, 1], Tw[1, 0, 0] = 1.0, -1.0
        Ts = np.zeros((3, 2, 2))
        Ts[0, 0, 0] = Ts[2, 1, 1] = 1.0
        Ts[1, 1, 0] = Ts[1, 0, 1] = 0.5
        ind = [[0, 1], [1, 2]]
    else:
        Tc = np.array([[[_eps(w, d, c) for d in range(3)] for c in range(3)]
                       for w in range(3)])
        Tw = np.array([[[_eps(c, d, e) for d in range(3)] for e in range(3)]
                       for c in range(3)])
        Ts = np.zeros((6, 3, 3))
        Ts[0, 0, 0] = Ts[2, 1, 1] = Ts[4, 2, 2] = 1.0
        for s, c, d in [(1, 1, 0), (1, 0, 1), (3, 2, 1), (3, 1, 2),
                        (5, 2, 0), (5, 0, 2)]:
            Ts[s, c, d] = 0.5
        ind = [[0, 1, 5], [1, 2, 3], [5, 3, 4]]
    Td = np.zeros((dim, Ts.shape[0], dim))
    for d in range(dim):
        for c in range(dim):
            Td[c, ind[d][c], d] = 1.0
    return Tc, Tw, Ts, Td


def _interleave(T, M, nn):
    """OUT[(a,o),(b,c)] = sum_d T[o,c,d] M[a,d,b]; T (do, di, dim)."""
    do, di = T.shape[:2]
    out = np.zeros((nn, do, nn, di))
    for o, c, d in zip(*np.nonzero(T)):
        out[:, o, :, c] += T[o, c, d] * M[:, d, :]
    return out.reshape(nn * do, nn * di)


@dataclasses.dataclass(frozen=True)
class Elements:
    """One element's matrices, interleaved dofs, float64."""
    K: np.ndarray       # (nn*dim, nn*dim)
    Rw: np.ndarray      # (nn*dim, nn*dim_w)
    SrT: np.ndarray     # (nn*dim_s, nn*dim)
    DivSrT: np.ndarray  # (nn*dim, nn*dim_s)
    Curl: np.ndarray    # (nn*dim_w, nn*dim)
    weight: np.ndarray  # (nn,) lumped weights


def element_matrices(dim, ngl, corners) -> Elements:
    """KLE matrices and nodal operators of one element with `corners`
    ((2**dim, dim), tensor order)."""
    nodes, opw = lobatto_points(ngl)
    full = _family(dim, nodes, *(gauss_points(ngl) if ngl <= 3
                                 else lobatto_points(ngl)))
    red = _family(dim, nodes, *gauss_points(ngl - 1))
    op = _family(dim, nodes, nodes, opw)
    Tc, Tw, Ts, Td = _tensors(dim)
    dim_w = Tc.shape[0]
    nn = ngl ** dim

    # full quadrature: vector Laplacian and the curl term of Rw
    Hxy, wd = _geometry(full, corners)
    L = np.einsum("q,qda,qdb->ab", wd, Hxy, Hxy)
    K = np.kron(L, np.eye(dim))
    M = np.einsum("q,qa,qdb->adb", wd, full.H, Hxy)
    Rw = _interleave(Tw, M, nn)
    # reduced quadrature: divergence and curl penalties
    Hr, wr = _geometry(red, corners)
    Z = Hr.transpose(0, 2, 1).reshape(Hr.shape[0], nn * dim)
    K = K + ALPHA_D * np.einsum("q,qi,qj->ij", wr, Z, Z)
    Bc = np.einsum("wcd,qda->qwac", Tc, Hr).reshape(Hr.shape[0], dim_w,
                                                     nn * dim)
    K = K + ALPHA_W * np.einsum("q,qwi,qwj->ij", wr, Bc, Bc)
    pen = np.einsum("q,qwi,qb->ibw", wr, Bc, red.H).reshape(nn * dim,
                                                            nn * dim_w)
    Rw = Rw + ALPHA_W * pen
    # nodal operators at the GLL points
    Ho, wo = _geometry(op, corners)
    Mo = np.einsum("q,qa,qdb->adb", wo, op.H, Ho)
    return Elements(K=K, Rw=Rw, SrT=_interleave(Ts, Mo, nn),
                    DivSrT=_interleave(Td, Mo, nn),
                    Curl=_interleave(Tc, Mo, nn),
                    weight=np.einsum("q,qa->a", wo, op.H))


# ---------------------------------------------------------------------- mesh
@dataclasses.dataclass(frozen=True)
class Box:
    ngl: int
    nelem: tuple
    lower: tuple
    upper: tuple

    @property
    def dim(self):
        return len(self.nelem)

    @property
    def npts(self):
        return tuple(n * (self.ngl - 1) + 1 for n in self.nelem)

    @property
    def n_nodes(self):
        return int(np.prod(self.npts))

    def axis_coords(self, d):
        gll, _ = lobatto_points(self.ngl)
        edges = np.linspace(self.lower[d], self.upper[d], self.nelem[d] + 1)
        pts = [edges[e] + (gll + 1.0) * 0.5 * (edges[e + 1] - edges[e])
               for e in range(self.nelem[d])]
        return np.concatenate([p[:-1] for p in pts[:-1]] + [pts[-1]])

    def coords(self):
        g = np.meshgrid(*[self.axis_coords(d) for d in range(self.dim)],
                        indexing="ij")
        return np.stack([a.ravel() for a in g], axis=-1)

    def cell_nodes(self):
        """(n_cells, nn) global node of each local node."""
        N, dim = self.ngl, self.dim
        strides = [int(np.prod(self.npts[d + 1:])) for d in range(dim)]
        ids = 0
        for d in range(dim):
            ax = (np.arange(self.nelem[d])[:, None] * (N - 1)
                  + np.arange(N)[None, :]) * strides[d]
            shape = [1] * (2 * dim)
            shape[d], shape[dim + d] = self.nelem[d], N
            ids = ids + ax.reshape(shape)
        return np.asarray(ids).reshape(-1, N ** dim).astype(np.int64)

    def corners(self):
        """The shared element's corners, (2**dim, dim), tensor order."""
        h = [(self.upper[d] - self.lower[d]) / self.nelem[d]
             for d in range(self.dim)]
        return np.array([[self.lower[d] + t[d] * h[d]
                          for d in range(self.dim)]
                         for t in itertools.product((0, 1),
                                                    repeat=self.dim)])

    def side_nodes(self, side):
        ax = SIDE_AXIS[side]
        grid = np.indices(self.npts).reshape(self.dim, -1)[ax]
        return np.where(grid == (self.npts[ax] - 1 if SIDE_MAX[side]
                                 else 0))[0]


# ----------------------------------------------------------------- boundary
@dataclasses.dataclass(frozen=True)
class Walls:
    """Boundary data of a case with constant side values."""
    free_main: np.ndarray    # (n, dim) bool: free dofs of the main solve
    free_fs: np.ndarray      # (n, dim) bool, or None: free-slip stage
    vel_nodes: np.ndarray    # (n, dim) bool: velocity written (all comps)
    vel_vals: np.ndarray     # (n, dim)
    vort_nodes: np.ndarray   # (n, dim_w) bool
    vort_vals: np.ndarray    # (n, dim_w)
    tang_nodes: np.ndarray   # (n, dim) bool: tangential re-pin after stage 1
    tang_vals: np.ndarray    # (n, dim)


def walls(box: Box, bc: dict) -> Walls:
    """Side sets and masks of a `no-slip` / `free-slip` config block whose
    sides carry constant velocities; later sides overwrite shared nodes."""
    dim = box.dim
    dim_w = 1 if dim == 2 else 3
    sides = []
    for kind in ("free-slip", "no-slip"):
        for name, vals in (bc.get(kind) or {}).items():
            if not isinstance(vals, (list, tuple)):
                raise ValueError(f"side {name}: only constant values")
            sides.append((name, kind, np.asarray(vals, dtype=np.float64)))
    if not sides or set(bc) - {"free-slip", "no-slip"}:
        raise ValueError(f"unsupported boundary block {sorted(bc)}")
    n = box.n_nodes
    dirichlet = np.zeros((n, dim), bool)
    normal = np.zeros((n, dim), bool)
    tang = np.zeros((n, dim), bool)
    vel_nodes = np.zeros((n, dim), bool)
    vel_vals = np.zeros((n, dim))
    tang_nodes = np.zeros((n, dim), bool)
    tang_vals = np.zeros((n, dim))
    for name, kind, v in sides:
        nodes = box.side_nodes(name)
        ax = SIDE_AXIS[name]
        vel_nodes[nodes] = True
        vel_vals[nodes] = v
        if kind == "free-slip":
            dirichlet[nodes] = True
            continue
        normal[nodes, ax] = True
        for d in range(dim):
            if d != ax:
                tang[nodes, d] = True
                tang_nodes[nodes, d] = True
                tang_vals[nodes, d] = v[d]
    both = normal[:, 0] & normal[:, 1]   # corner rule: y-normal wins
    normal[both, 0] = False
    tang &= ~normal & ~dirichlet
    normal &= ~dirichlet
    ns = any(kind == "no-slip" for _, kind, _ in sides)
    vort_nodes = np.repeat(vel_nodes[:, :1], dim_w, axis=1)
    return Walls(free_main=~(dirichlet | normal | tang),
                 free_fs=~(dirichlet | normal) if ns else None,
                 vel_nodes=vel_nodes, vel_vals=vel_vals,
                 vort_nodes=vort_nodes, vort_vals=np.zeros((n, dim_w)),
                 tang_nodes=tang_nodes, tang_vals=tang_vals)
