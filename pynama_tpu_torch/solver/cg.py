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

Spans (utils/profiling.py; no-ops unless a trace is on): every operator
application is a `pcg.apply`, every preconditioner application a
`pcg.precond`, the host read of `run` a `pcg.check`, and the rest of the
loop's launches (dots, scalar and vector updates) `pcg.update`. The
condition `run` of the next iteration is formed at the end of the body,
inside the same `pcg.update` as the updates it reads.

Stopping rule, exactly the reference's: iterate while rr > tol2 and
k < maxiter and gamma > 0 and bnorm2 > 0, with tol2 = max(rtol·||b||,
atol)^2, and alpha = 0 where pAp <= 0.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pynama_tpu_torch.utils.profiling import span


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
        check_every: int = 8, dots: Callable | None = None) -> CGResult:
    """Solve A x = b with preconditioned CG.

    A and M_inv are linear callables on tensors of b's shape. Stopping:
    ||r||_2 <= max(rtol * ||b||_2, atol), capped at maxiter iterations.

    A0, when given, is used ONLY for the initial residual r0 = b - A0(x0):
    the caller guarantees A(v) == A0(v) for every vector the loop produces
    (the Dirichlet-condensed KLE operator, whose loop iterates are exactly
    zero on constrained dofs; see local_engine._masked_solve).

    dots(pairs), when given, returns [dot(a, b) for a, b in pairs] in one
    go (a sharded run reduces them in one collective); the values must be
    those of `dot`.
    """
    if M_inv is None:
        M_inv = lambda r: r
    if dot is None:
        dot = _vdot
    if dots is None:
        dots = lambda pairs: [dot(a, c) for a, c in pairs]

    with span("pcg.apply"):
        r = (A0 if A0 is not None else A)(x0)
    with span("pcg.update"):
        r = b - r                # frees A x0: no vector outlives its use
    with span("pcg.precond"):
        z = M_inv(r)
    with span("pcg.update"):
        gamma, rr, bnorm2 = dots([(r, z), (r, r), (b, b)])
        tol2 = torch.clamp(rtol * torch.sqrt(bnorm2), min=atol) ** 2
        x, p = x0, z
        k = torch.zeros((), dtype=torch.int64, device=b.device)
        zero = torch.zeros((), dtype=b.dtype, device=b.device)
        one = torch.ones((), dtype=b.dtype, device=b.device)
        live = bnorm2 > 0            # loop-invariant part of the condition
        run = (rr > tol2) & (k < maxiter) & (gamma > 0) & live

    n = 0
    while n < maxiter:
        if n % check_every == 0:
            with span("pcg.check"):
                stop = not bool(run)
            if stop:
                break
        with span("pcg.apply"):
            Ap = A(p)
        with span("pcg.update"):
            pAp = dot(p, Ap)
            ok = run & (pAp > 0)
            alpha = torch.where(ok, gamma / torch.where(ok, pAp, one), zero)
            x = x + alpha * p
            r = r - alpha * Ap
        with span("pcg.precond"):
            z = M_inv(r)
        with span("pcg.update"):
            gamma_new, rr_new = dots([(r, z), (r, r)])
            beta = torch.where(run, gamma_new / torch.where(run, gamma, one),
                               zero)
            p = z + beta * p
            gamma = torch.where(run, gamma_new, gamma)
            rr = torch.where(run, rr_new, rr)
            k = k + run.to(k.dtype)
            run = (rr > tol2) & (k < maxiter) & (gamma > 0) & live
        n += 1
    with span("pcg.update"):
        x = torch.where(live, x, torch.zeros_like(x))
        residual = torch.sqrt(rr)
    return CGResult(x=x, iters=k, residual=residual, loop_applies=n)
