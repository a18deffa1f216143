"""Restarted, left-preconditioned GMRES(m) in eager PyTorch.

Port of pynama_tpu/solver/gmres.py, the KSP-GMRES analog. CG is the better
fit for the SPD KLE operator (`solver/cg.py`); GMRES is kept for
non-symmetric systems and for KSP parity.

Same algorithm and stopping rule as the JAX version: left preconditioning,
convergence measured in the preconditioned residual norm,
||M^-1 r||_2 <= max(rtol * ||M^-1 b||_2, atol), at most maxiter Arnoldi
steps in all. One restart cycle is modified Gram-Schmidt against the basis
built so far, then Givens rotations of the new Hessenberg column.

The JAX version masks a fixed (m+1)-slot basis that is zero beyond step j
(`w - 0*V[i]` is bitwise `w`); here Gram-Schmidt runs over i <= j and the
rotations over k < j only, which gives the same iterate. The vectors stay
on the device. The Hessenberg column (j+2 numbers) comes to the host once
per Arnoldi step, where the rotations, the residual estimate |g[j]| and the
small triangular solve run in numpy in the runtime dtype, as the JAX
version runs them on the device; that read is the step's one host sync.

On exact breakdown (the Krylov space is exhausted) the rotation keeps the
triangular solve nonsingular: unit diagonal, zero rhs, so x is unchanged by
that column, as in the JAX version.

Operator applications: one for the initial residual, one for each restart
cycle's fresh residual, one per Arnoldi step; `GMRESResult.applies` counts
them all.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg
import torch

from pynama_tpu_torch.solver.cg import vdot


class GMRESResult(NamedTuple):
    x: torch.Tensor
    #: Arnoldi steps taken (host int)
    iters: int
    #: the preconditioned residual estimate |g[j]| at exit (host float)
    residual: float
    #: operator applications made, every one counted (host int)
    applies: int


def gmres(A: Callable, b: torch.Tensor, x0: torch.Tensor,
          M_inv: Callable | None = None, rtol: float = 1e-12,
          atol: float = 0.0, maxiter: int = 1000, restart: int = 30,
          dot: Callable | None = None) -> GMRESResult:
    """Solve A x = b with restarted, left-preconditioned GMRES(m).

    A and M_inv are linear callables on tensors of b's shape; `dot` is the
    inner product (default: the plain sum of products). Stopping:
    ||M^-1 r||_2 <= max(rtol * ||M^-1 b||_2, atol), capped at maxiter
    total Arnoldi steps.
    """
    if M_inv is None:
        M_inv = lambda r: r
    if dot is None:
        dot = vdot

    m = int(restart)
    shape = b.shape
    nt = torch.empty((), dtype=b.dtype).numpy().dtype.type
    eps = nt(np.finfo(nt).tiny)
    applies = 0

    Mb = M_inv(b)
    bnorm = nt(torch.sqrt(dot(Mb, Mb)).item())
    tol = max(nt(rtol) * bnorm, nt(atol))

    def cycle(x, it):
        """One GMRES(m) restart cycle from the current iterate x."""
        nonlocal applies
        r = M_inv(b - A(x))
        applies += 1
        beta = torch.sqrt(dot(r, r))
        V = torch.zeros((m + 1,) + tuple(shape), dtype=b.dtype,
                        device=b.device)
        V[0] = r / torch.clamp(beta, min=float(eps))
        R = np.zeros((m + 1, m), nt)         # rotated Hessenberg columns
        cs = np.zeros(m, nt)
        sn = np.zeros(m, nt)
        g = np.zeros(m + 1, nt)
        g[0] = beta.item()
        j = 0
        while j < m and abs(g[j]) > tol and it < maxiter:
            w = M_inv(A(V[j]))
            applies += 1
            hs = []
            for i in range(j + 1):           # modified Gram-Schmidt
                hij = dot(V[i], w)
                w = w - hij * V[i]
                hs.append(hij)
            hlast = torch.sqrt(dot(w, w))
            V[j + 1] = w / torch.clamp(hlast, min=float(eps))
            h = np.zeros(m + 1, nt)
            h[:j + 2] = torch.stack(hs + [hlast]).cpu().numpy()

            for k in range(j):               # previous rotations
                t1 = cs[k] * h[k] + sn[k] * h[k + 1]
                t2 = -sn[k] * h[k] + cs[k] * h[k + 1]
                h[k], h[k + 1] = t1, t2

            # new rotation zeroing h[j+1]
            denom = np.sqrt(h[j] * h[j] + h[j + 1] * h[j + 1])
            ok = denom > eps
            c_j = h[j] / max(denom, eps) if ok else nt(1.0)
            s_j = h[j + 1] / max(denom, eps) if ok else nt(0.0)
            h[j] = denom if ok else nt(1.0)
            h[j + 1] = 0.0
            g[j + 1] = -s_j * g[j]
            g[j] = c_j * g[j] if ok else nt(0.0)
            R[:, j] = h
            cs[j], sn[j] = c_j, s_j
            j += 1
            it += 1

        if j:
            y = scipy.linalg.solve_triangular(R[:j, :j], g[:j], lower=False)
            yt = torch.as_tensor(y.astype(nt), device=b.device)
            x = x + torch.tensordot(yt, V[:j], dims=1)
        return x, it, nt(abs(g[j]))

    r0 = M_inv(b - A(x0))
    applies += 1
    res = nt(torch.sqrt(dot(r0, r0)).item())
    x, it = x0, 0
    while res > tol and it < maxiter:
        x, it, res = cycle(x, it)
    return GMRESResult(x=x, iters=it, residual=float(res), applies=applies)
