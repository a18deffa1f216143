"""Preconditioned conjugate gradients with a device-side stopping flag.

Port of pynama_tpu/solver/cg.py. The JAX version runs the loop under
`lax.while_loop`, whose condition is evaluated on the device. Eager PyTorch
would need a host sync per iteration to test it. Instead the loop keeps the
reference's condition as a device boolean `run` and folds it into the
update: once `run` is false, alpha and beta are zero and the scalars stay
frozen, so x and r never change again. The host reads `run` only every
`check_every` iterations and then stops. The iterate and the iteration
count are those of the reference; the cost is up to `check_every - 1`
operator applications after convergence, against one host sync per
iteration saved.

Stopping rule, exactly the reference's: iterate while rr > tol2 and
k < maxiter and gamma > 0 and bnorm2 > 0, with tol2 = max(rtol·||b||,
atol)^2, and alpha = 0 where pAp <= 0.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    #: iterations the reference loop would run (0-d int tensor, on device)
    iters: torch.Tensor
    residual: torch.Tensor
    #: operator applications the loop actually made (host int, >= iters)
    loop_applies: int


def _vdot(a, b):
    return (a * b).sum()


def pcg(A: Callable, b: torch.Tensor, x0: torch.Tensor,
        M_inv: Callable | None = None, rtol: float = 1e-12,
        atol: float = 0.0, maxiter: int = 1000,
        dot: Callable | None = None, A0: Callable | None = None,
        check_every: int = 8) -> CGResult:
    """Solve A x = b with preconditioned CG.

    A and M_inv are linear callables on tensors of b's shape. Stopping:
    ||r||_2 <= max(rtol * ||b||_2, atol), capped at maxiter iterations.

    A0, when given, is used ONLY for the initial residual r0 = b - A0(x0):
    the caller guarantees A(v) == A0(v) for every vector the loop produces
    (the Dirichlet-condensed KLE operator, whose loop iterates are exactly
    zero on constrained dofs; see local_engine._masked_solve).
    """
    if M_inv is None:
        M_inv = lambda r: r
    if dot is None:
        dot = _vdot

    r = b - (A0 if A0 is not None else A)(x0)
    z = M_inv(r)
    gamma = dot(r, z)
    rr = dot(r, r)
    bnorm2 = dot(b, b)
    tol2 = torch.clamp(rtol * torch.sqrt(bnorm2), min=atol) ** 2
    x, p = x0, z
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    live = bnorm2 > 0            # loop-invariant part of the condition

    n = 0
    while n < maxiter:
        run = (rr > tol2) & (k < maxiter) & (gamma > 0) & live
        if n % check_every == 0 and not bool(run):
            break
        Ap = A(p)
        pAp = dot(p, Ap)
        ok = run & (pAp > 0)
        alpha = torch.where(ok, gamma / torch.where(ok, pAp, one), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        gamma_new = dot(r, z)
        rr_new = dot(r, r)
        beta = torch.where(run, gamma_new / torch.where(run, gamma, one),
                           zero)
        p = z + beta * p
        gamma = torch.where(run, gamma_new, gamma)
        rr = torch.where(run, rr_new, rr)
        k = k + run.to(k.dtype)
        n += 1
    x = torch.where(live, x, torch.zeros_like(x))
    return CGResult(x=x, iters=k, residual=torch.sqrt(rr), loop_applies=n)
