"""The plain reference of the 3D Taylor-Green march on the benchmark's
distorted hex mesh of the unit cube (`meshes/hex_cube.py`), in PyTorch on
the global node layout.

What it builds, from the case's config dict and nothing of the measured
package:

- the mesh: the hex corners from `hex_cube.corners` (never the gmsh file
  the program reads), its own GLL nodes mapped through each hex's
  trilinear map, and global nodes numbered on the grid's (n(ngl-1)+1)^3
  lattice (`setup.Box.cell_nodes`: the hexes are a distorted grid, so
  node (i(ngl-1)+a, ...) is local node a of hex (i, ...));
- per-element matrices, every element its own, built batched in float64
  on the device from `setup.py`'s quadrature tables: K (stiffness
  + ALPHA_D * divergence + ALPHA_W * curl penalties, the penalties under
  the reduced Gauss family), Rw, and the nodal Curl, SrT and DivSrT with
  the lumped weights at the GLL nodes (SURVEY section 0);
- the walls: every boundary node carries the case's `taylor_green3d`
  velocity and vorticity at the time of the evaluation (its own copy of
  the formula below), on every component, as the measured solver's
  `custom-func` boundary block states it; the one KLE system is the
  Dirichlet-condensed K on the interior dofs;
- the KLE solve: the f64 Cholesky factor at or below `direct_max_dofs`
  velocity dofs, else a Jacobi-preconditioned CG to `cg_rtol` (1e-11), the
  route the measured solver states for this boundary type; the march is
  `cavity.Case.march` (the Bogacki-Shampine 5(4) pair, the PETSc 'basic'
  controller, MATCHSTEP), the rhs `cavity.Case.rhs`.

Fields come in and go out in the canonical node order
(`hex_cube.canonical_order`), and `coords` is in that order: the program
numbers its nodes its own way, so both sides sort theirs.

Departures from the upstream's description: the mesh is the benchmark's
distorted grid (the upstream case runs a box); the wall values of an
accepted state are those of the time of the step's last stage, which is
the step's end (the tableau's last node is 1.0 exactly); and `tf32=True`
makes the lower-precision control as in `cavity.py` (every product's
operands rounded to TF32).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from meshes import hex_cube
from reference import cavity
from reference.cavity import round_tf32
from reference.setup import (ALPHA_D, ALPHA_W, Box, _family, _tensors,
                             gauss_points, lagrange, lobatto_points)


def taylor_green3d(coords: torch.Tensor, alpha: float):
    """(velocity, vorticity) of the unit-box 3D Taylor-Green field at
    `coords` (n, 3), scaled by alpha(t) = exp(-12 pi^2 nu t)."""
    x, y, z = (2 * math.pi * coords[:, d] for d in range(3))
    vel = torch.stack([torch.cos(x) * torch.sin(y) * torch.sin(z),
                       torch.sin(x) * torch.cos(y) * torch.sin(z),
                       -2 * torch.sin(x) * torch.sin(y) * torch.cos(z)], 1)
    vort = torch.stack([-6 * math.pi * torch.sin(x) * torch.cos(y)
                        * torch.cos(z),
                        6 * math.pi * torch.cos(x) * torch.sin(y)
                        * torch.cos(z),
                        torch.zeros_like(x)], 1)
    return alpha * vel, alpha * vort


def alpha(nu: float, t: float) -> float:
    return math.exp(-12 * math.pi ** 2 * nu * t)


def _geometry(fam, corners):
    """(Hxy (E, nq, 3, nn) physical derivatives, w det J (E, nq))."""
    kw = dict(dtype=corners.dtype, device=corners.device)
    DC, D = (torch.as_tensor(a, **kw) for a in (fam.DC, fam.D))
    J = torch.einsum("qra,eap->eqrp", DC, corners)
    Hxy = torch.einsum("eqpr,qra->eqpa", torch.linalg.inv(J), D)
    return Hxy, torch.as_tensor(fam.w, **kw) * torch.linalg.det(J)


def _interleave(T, M):
    """OUT[e, (a,o), (b,c)] = sum_d T[o,c,d] M[e,a,d,b], M (E, nn, 3, nn)."""
    E, nn = M.shape[:2]
    do, di = T.shape[:2]
    out = M.new_zeros((E, nn, do, nn, di))
    for o, c, d in zip(*np.nonzero(T)):
        out[:, :, o, :, c] += float(T[o, c, d]) * M[:, :, d, :]
    return out.reshape(E, nn * do, nn * di)


def element_matrices(ngl: int, corners: torch.Tensor) -> dict:
    """Every element's K, Rw, Curl, SrT, DivSrT (interleaved dofs) and
    lumped weights, batched over the (E, 8, 3) corners, in their dtype."""
    dim = 3
    nodes, opw = lobatto_points(ngl)
    full = _family(dim, nodes, *(gauss_points(ngl) if ngl <= 3
                                 else lobatto_points(ngl)))
    red = _family(dim, nodes, *gauss_points(ngl - 1))
    op = _family(dim, nodes, nodes, opw)
    Tc, Tw, Ts, Td = _tensors(dim)
    kw = dict(dtype=corners.dtype, device=corners.device)
    E, nn = corners.shape[0], ngl ** dim

    Hxy, wd = _geometry(full, corners)
    L = torch.einsum("eq,eqda,eqdb->eab", wd, Hxy, Hxy)
    K = corners.new_zeros((E, nn, dim, nn, dim))
    for c in range(dim):
        K[:, :, c, :, c] = L
    K = K.reshape(E, nn * dim, nn * dim)
    M = torch.einsum("eq,qa,eqdb->eadb", wd, torch.as_tensor(full.H, **kw),
                     Hxy)
    Rw = _interleave(Tw, M)
    Hr, wr = _geometry(red, corners)
    Z = Hr.transpose(2, 3).reshape(E, -1, nn * dim)
    K += ALPHA_D * torch.einsum("eq,eqi,eqj->eij", wr, Z, Z)
    Bc = torch.einsum("wcd,eqda->eqwac", torch.as_tensor(Tc, **kw),
                      Hr).reshape(E, -1, Tc.shape[0], nn * dim)
    K += ALPHA_W * torch.einsum("eq,eqwi,eqwj->eij", wr, Bc, Bc)
    Rw += ALPHA_W * torch.einsum("eq,eqwi,qb->eibw", wr, Bc, torch.as_tensor(
        red.H, **kw)).reshape(E, nn * dim, nn * Tc.shape[0])
    Ho, wo = _geometry(op, corners)
    Ht = torch.as_tensor(op.H, **kw)
    Mo = torch.einsum("eq,qa,eqdb->eadb", wo, Ht, Ho)
    return {"K": K, "Rw": Rw, "Curl": _interleave(Tc, Mo),
            "SrT": _interleave(Ts, Mo), "DivSrT": _interleave(Td, Mo),
            "weight": torch.einsum("eq,qa->ea", wo, Ht)}


class Case(cavity.Case):
    """The Taylor-Green case on the hex cube: its operators, its KLE solve
    and its march (`cavity.Case`'s, on per-element matrices)."""

    def __init__(self, config: dict, *, device, dtype=torch.float64,
                 tf32=False, cg_rtol=1e-11, cg_maxiter=50000,
                 direct_max_dofs=40_000):
        # every product in the stated precision: no TF32 (the control
        # rounds its operands to TF32 itself)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dom = config["domain"]
        hc = dom["hex-cube"]
        ngl, nelem = int(dom["ngl"]), tuple(int(n) for n in hc["nelem"])
        mat = config["material-properties"]
        self.rho, self.mu = float(mat["rho"]), float(mat["mu"])
        self.nu = self.mu / self.rho
        self.dim, self.dim_w, self.dim_s = 3, 3, 6
        self.device, self.dtype, self.tf32 = torch.device(device), dtype, tf32
        self.cg_rtol, self.cg_maxiter = float(cg_rtol), int(cg_maxiter)
        self.cg_iters = []
        kw = dict(device=self.device, dtype=dtype)
        f64 = dict(device=self.device, dtype=torch.float64)

        box = Box(ngl, nelem, (0.0,) * 3, (1.0,) * 3)
        cn = box.cell_nodes()
        self.n = n = box.n_nodes
        self.cell_nodes = torch.as_tensor(cn, device=self.device)
        corners = torch.as_tensor(hex_cube.corners(nelem, float(hc["distort"]),
                                                   int(hc.get("rng", 0))),
                                  **f64)
        # node coordinates: each hex's GLL nodes through its trilinear map
        gll, _ = lobatto_points(ngl)
        h, _ = lagrange(np.array([-1.0, 1.0]), gll)
        Hn = np.einsum("ai,bj,ck->abcijk", h, h, h).reshape(ngl ** 3, 8)
        xyz = torch.zeros((n, 3), **f64)
        xyz[self.cell_nodes.reshape(-1)] = torch.einsum(
            "ak,ekp->eap", torch.as_tensor(Hn, **f64), corners).reshape(-1, 3)
        self._xyz = xyz
        order = hex_cube.canonical_order(xyz.cpu().numpy())
        self.order = torch.as_tensor(order, device=self.device)
        self.unorder = torch.argsort(self.order)
        self.coords = xyz.cpu().numpy()[order]

        el = element_matrices(ngl, corners)
        mats = {k: el[k].transpose(1, 2).to(dtype).contiguous()
                for k in ("K", "Rw", "SrT", "DivSrT", "Curl")}
        if tf32:
            mats = {k: round_tf32(v) for k, v in mats.items()}
        self.matT = mats
        w = torch.zeros(n, **f64).index_add_(0, self.cell_nodes.reshape(-1),
                                             el["weight"].reshape(-1))
        self.winv = (1.0 / w).to(dtype)[:, None]
        K_el = el["K"].to(dtype)
        del el

        wall = np.zeros(n, bool)
        for side in ("left", "right", "down", "up", "back", "front"):
            wall[box.side_nodes(side)] = True
        self.wall = torch.as_tensor(wall, device=self.device)
        mask = torch.as_tensor(wall, **kw)[:, None]
        self.vel_mask = mask.expand(n, 3).contiguous()
        self.vort_mask = self.vel_mask
        self._vel1, self._vort1 = taylor_green3d(xyz[self.wall], 1.0)
        self._t = 0.0
        self.direct = n * 3 <= direct_max_dofs
        self.systems = [self._system(1.0 - self.vel_mask, K_el)]

    # ------------------------------------------------------------- the walls
    def _walls(self, field1) -> torch.Tensor:
        """A field on every node holding `field1` scaled by alpha(t) on the
        walls, t the time of the last rhs evaluation (the march's stage
        time, and the step's end at its accept)."""
        out = torch.zeros((self.n, 3), device=self.device,
                          dtype=torch.float64)
        out[self.wall] = alpha(self.nu, self._t) * field1
        return out.to(self.dtype)

    @property
    def vel_vals(self):
        return self._walls(self._vel1)

    @property
    def vort_vals(self):
        return self._walls(self._vort1)

    def rhs(self, t, vort, vel):
        self._t = float(t)
        return super().rhs(t, vort, vel)

    # -------------------------------------------------------------- operators
    def apply(self, name, x):
        """Assembled per-element operator `name` on a global field x (n,
        cin)."""
        E, nn = self.cell_nodes.shape
        xe = x[self.cell_nodes].reshape(E, 1, -1)
        if self.tf32:
            xe = round_tf32(xe)
        ye = torch.bmm(xe, self.matT[name])
        cout = ye.shape[-1] // nn
        y = torch.zeros((self.n, cout), device=x.device, dtype=x.dtype)
        return y.index_add_(0, self.cell_nodes.reshape(-1),
                            ye.reshape(E * nn, cout))

    # ------------------------------------------------------------- KLE solve
    def _system(self, free, K_el):
        """(free, Cholesky factor or None, Jacobi diagonal) of the system
        free*K*free + (1-free) = rhs, K assembled from per-element K_el."""
        con = 1.0 - free
        E, nn = self.cell_nodes.shape
        N = self.n * 3
        rows = (self.cell_nodes[:, :, None] * 3
                + torch.arange(3, device=self.device)).reshape(E, -1)
        diag = torch.zeros(N, device=self.device, dtype=self.dtype)
        diag.index_add_(0, rows.reshape(-1),
                        torch.diagonal(K_el, dim1=1, dim2=2).reshape(-1))
        diag = diag.reshape(self.n, 3) * free + con
        if not self.direct:
            return free, None, diag
        A = torch.zeros((N, N), device=self.device, dtype=self.dtype)
        A.index_put_((rows[:, :, None], rows[:, None, :]), K_el,
                     accumulate=True)
        fr = free.reshape(-1)
        A.mul_(fr[:, None]).mul_(fr[None, :])
        A.diagonal().add_(con.reshape(-1))
        if self.tf32:
            A = round_tf32(A)
        return free, torch.linalg.cholesky(A), diag

    # ------------------------------------------------------------------ march
    def march(self, vort, vel, t_end, dt0, atol, rtol, max_steps=100_000,
              **kw):
        """`cavity.Case.march` from t = 0 on fields in canonical order:
        (t, vort, vel, accepted steps), the fields in canonical order."""
        self._t = 0.0
        t, w, v, steps = super().march(vort[self.unorder], vel[self.unorder],
                                       t_end, dt0, atol, rtol,
                                       max_steps=max_steps, **kw)
        return t, w[self.order], v[self.order], steps
