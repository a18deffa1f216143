"""The plain reference of a cavity march, in PyTorch on the global node
layout.

Everything is rebuilt from the case's config dict (`setup.py`): the
operators are gather -> one batched matmul -> index_add over the element
node table, the two-stage KLE velocity solve is a dense Cholesky factor
(at or below `direct_max_dofs` velocity dofs) or a Jacobi-preconditioned
CG to a tight tolerance, and the time march is the Bogacki-Shampine 5(4)
pair with the PETSc 'basic' step controller and MATCHSTEP, as the measured
solver states them.

`tf32=True` makes the lower-precision control: every matmul operand (the
element matrices, the gathered element vectors and the assembled dense
system) is rounded to TF32's 10 mantissa bits before the product, the
rounding the tensor cores apply, so the control computes in TF32 on any
device. Run it in float32 with the cell's own solver settings.
"""
from __future__ import annotations

import numpy as np
import torch

from reference.setup import Box, element_matrices, walls

# Bogacki-Shampine 5(4), 8 stages (PETSc TSRK5BS)
_A = np.zeros((8, 8))
_A[1, 0] = 1 / 6
_A[2, :2] = [2 / 27, 4 / 27]
_A[3, :3] = [183 / 1372, -162 / 343, 1053 / 1372]
_A[4, :4] = [68 / 297, -4 / 11, 42 / 143, 1960 / 3861]
_A[5, :5] = [597 / 22528, 81 / 352, 63099 / 585728, 58653 / 366080,
             4617 / 20480]
_A[6, :6] = [174197 / 959244, -30942 / 79937, 8152137 / 19744439,
             666106 / 1039181, -29421 / 29068, 482048 / 414219]
_B = np.array([587 / 8064, 0.0, 4440339 / 15491840, 24353 / 124800,
               387 / 44800, 2152 / 5985, 7267 / 94080, 0.0])
_A[7, :] = _B
_BE = np.array([2479 / 34992, 0.0, 123 / 416, 612941 / 3411720,
                43 / 1440, 2272 / 6561, 79937 / 1113912, 3293 / 556956])
_C = _A.sum(axis=1)
ORDER = 5


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


class Case:
    """One cavity case: its operators, its KLE solve and its march."""

    def __init__(self, config: dict, *, device, dtype=torch.float64,
                 tf32=False, cg_rtol=1e-11, cg_maxiter=50000,
                 direct_max_dofs=40_000):
        dom = config["domain"]
        box_cfg = dom.get("box-mesh", dom)
        self.box = Box(int(dom["ngl"]), tuple(box_cfg["nelem"]),
                       tuple(float(x) for x in box_cfg["lower"]),
                       tuple(float(x) for x in box_cfg["upper"]))
        mat = config["material-properties"]
        self.rho, self.mu = float(mat["rho"]), float(mat["mu"])
        self.dim = dim = self.box.dim
        self.dim_w = 1 if dim == 2 else 3
        self.dim_s = 3 if dim == 2 else 6
        self.device, self.dtype, self.tf32 = torch.device(device), dtype, tf32
        self.cg_rtol, self.cg_maxiter = float(cg_rtol), int(cg_maxiter)
        self.cg_iters = []
        kw = dict(device=self.device, dtype=dtype)

        el = element_matrices(dim, self.box.ngl, self.box.corners())
        mats = {k: torch.as_tensor(getattr(el, k).T.copy(), **kw)
                for k in ("K", "Rw", "SrT", "DivSrT", "Curl")}
        if tf32:
            mats = {k: round_tf32(v) for k, v in mats.items()}
        self.matT = mats
        cn = self.box.cell_nodes()
        self.n = n = self.box.n_nodes
        self.cell_nodes = torch.as_tensor(cn, device=self.device)
        w = np.zeros(n)
        np.add.at(w, cn, np.broadcast_to(el.weight, cn.shape))
        self.winv = torch.as_tensor(1.0 / w, **kw)[:, None]
        self.coords = self.box.coords()

        wl = walls(self.box, config["boundary-conditions"])
        f = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), **kw)
        self.vel_mask, self.vel_vals = f(wl.vel_nodes), f(wl.vel_vals)
        self.vort_mask, self.vort_vals = f(wl.vort_nodes), f(wl.vort_vals)
        self.tang_mask, self.tang_vals = f(wl.tang_nodes), f(wl.tang_vals)
        self.direct = n * dim <= direct_max_dofs
        self.systems = [self._system(f(fm), el.K, cn)
                        for fm in (wl.free_fs, wl.free_main)
                        if fm is not None]

    # -------------------------------------------------------------- operators
    def apply(self, name, x):
        """Assembled element operator `name` on a global field x (n, cin)."""
        E, nn = self.cell_nodes.shape
        xe = x[self.cell_nodes].reshape(E, -1)
        if self.tf32:
            xe = round_tf32(xe)
        ye = xe @ self.matT[name]
        cout = ye.shape[1] // nn
        y = torch.zeros((self.n, cout), device=x.device, dtype=x.dtype)
        return y.index_add_(0, self.cell_nodes.reshape(-1),
                            ye.reshape(E * nn, cout))

    def curl(self, v):
        return self.apply("Curl", v) * self.winv

    def srt(self, v):
        return self.apply("SrT", v) * self.winv

    def div_srt(self, s):
        return self.apply("DivSrT", s) * self.winv

    def vtensv(self, v):
        if self.dim == 2:
            pairs = [(0, 0), (0, 1), (1, 1)]
        else:
            pairs = [(0, 0), (0, 1), (1, 1), (1, 2), (2, 2), (2, 0)]
        return torch.stack([v[:, i] * v[:, j] for i, j in pairs], dim=1)

    # ------------------------------------------------------------- KLE solve
    def _system(self, free, K_el, cn):
        """(free, Cholesky factor or None, Jacobi diagonal) of the system
        free*K*free + (1-free) = rhs."""
        con = 1.0 - free
        N, dim = self.n * self.dim, self.dim
        rows = torch.as_tensor((cn[:, :, None] * dim + np.arange(dim))
                               .reshape(cn.shape[0], -1), device=self.device)
        K = torch.as_tensor(K_el, device=self.device, dtype=self.dtype)
        diag = torch.zeros(N, device=self.device, dtype=self.dtype)
        diag.index_add_(0, rows.reshape(-1),
                        torch.diagonal(K).repeat(cn.shape[0]))
        diag = diag.reshape(self.n, dim) * free + con
        if not self.direct:
            return free, None, diag
        A = torch.zeros((N, N), device=self.device, dtype=self.dtype)
        Kb = K.expand(cn.shape[0], -1, -1)
        A.index_put_((rows[:, :, None], rows[:, None, :]), Kb,
                     accumulate=True)
        fr = free.reshape(-1)
        A.mul_(fr[:, None]).mul_(fr[None, :])
        A.diagonal().add_(con.reshape(-1))
        if self.tf32:
            A = round_tf32(A)
        L = torch.linalg.cholesky(A)
        del A
        return free, L, diag

    def _solve(self, system, vort, vel):
        free, L, diag = system
        con = 1.0 - free
        vc = con * vel
        b = free * (self.apply("Rw", vort) - self.apply("K", vc)) + vc
        if L is not None:
            y = torch.linalg.solve_triangular(L, b.reshape(-1, 1), upper=False)
            x = torch.linalg.solve_triangular(L.mT, y, upper=True)
            return x.reshape(vel.shape)

        def A(v):
            return free * self.apply("K", free * v) + con * v

        return self._pcg(A, b, vel, lambda r: r / diag)

    def _pcg(self, A, b, x, M_inv, check=16):
        r = b - A(x)
        z = M_inv(r)
        p = z
        rz = (r * z).sum()
        tol2 = (self.cg_rtol ** 2) * float((b * b).sum())
        k = 0
        while k < self.cg_maxiter:
            if k % check == 0 and float((r * r).sum()) <= tol2:
                break
            Ap = A(p)
            alpha = rz / (p * Ap).sum()
            x = x + alpha * p
            r = r - alpha * Ap
            z = M_inv(r)
            rz_new = (r * z).sum()
            p = z + (rz_new / rz) * p
            rz = rz_new
            k += 1
        self.cg_iters.append(k)
        return x

    def solve_kle(self, vort, vel):
        """Boundary writes and the (two-stage) KLE solve: (vort, vel)."""
        vort = vort * (1 - self.vort_mask) + self.vort_vals * self.vort_mask
        vel = vel * (1 - self.vel_mask) + self.vel_vals * self.vel_mask
        if len(self.systems) == 2:
            v_fs = self._solve(self.systems[0], vort, vel)
            v_fs = v_fs * (1 - self.tang_mask) \
                + self.tang_vals * self.tang_mask
            vort = self.curl(v_fs)
        return vort, self._solve(self.systems[-1], vort, vel)

    def rhs(self, t, vort, vel):
        _, vel = self.solve_kle(vort, vel)
        aux = 2.0 * self.mu * self.srt(vel) - self.rho * self.vtensv(vel)
        return self.curl(self.div_srt(aux) / self.rho), vel

    # ------------------------------------------------------------------ march
    def march(self, vort, vel, t_end, dt0, atol, rtol, max_steps=100_000,
              safety=0.9, clip=(0.1, 10.0), dt_min=1e-14):
        """Adaptive march from t = 0 to t_end (MATCHSTEP): (t, vort, vel,
        accepted steps). The accepted state gets the vorticity wall values."""
        t, dt, steps = 0.0, float(dt0), 0
        while steps < max_steps and t < t_end - 1e-14 * max(1.0, abs(t_end)):
            dt = min(dt, t_end - t)
            ks, aux = [], vel
            for i in range(8):
                yi = vort
                for j in range(i):
                    if _A[i, j] != 0.0:
                        yi = yi + float(dt * _A[i, j]) * ks[j]
                k, aux = self.rhs(t + float(_C[i]) * dt, yi, aux)
                ks.append(k)
            y5, y4 = vort, vort
            for j in range(8):
                if _B[j] != 0.0:
                    y5 = y5 + float(dt * _B[j]) * ks[j]
                if _BE[j] != 0.0:
                    y4 = y4 + float(dt * _BE[j]) * ks[j]
            w = atol + rtol * torch.maximum(vort.abs(), y5.abs())
            enorm = float(torch.sqrt(torch.mean(((y5 - y4) / w) ** 2)))
            if not np.isfinite(enorm):
                dt *= 0.25
                if dt < dt_min:
                    raise RuntimeError("reference: dt underflow")
                continue
            factor = min(max(safety * max(enorm, 1e-30) ** (-1.0 / ORDER),
                             clip[0]), clip[1])
            if enorm <= 1.0:
                t += dt
                steps += 1
                vort = y5 * (1 - self.vort_mask) \
                    + self.vort_vals * self.vort_mask
                vel = aux
            dt *= factor
            if enorm > 1.0 and dt < dt_min:
                raise RuntimeError("reference: dt underflow")
        return t, vort, vel, steps
