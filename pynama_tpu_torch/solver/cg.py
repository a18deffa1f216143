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

The fused epilogue (`epilogue=`, ops/cg_epilogue.py): the loop's work
between one operator application and the next runs as three hand-written
CUDA kernels on a card (cg_pap, cg_xr, cg_p; four, with cg_rz, where the
preconditioner is not pointwise and stays an eager call), in place of some
36 eager launches, with every CG scalar (gamma, rr, pAp, alpha, beta, k,
run) kept on the card. The prologue (the first residual, tol2, live), the
stop checks and the counts are the eager loop's. On the CPU the kernels'
plain versions repeat the eager loop's expressions: the iterates, the
iteration count and `loop_applies` are bitwise the eager loop's. On a card
the kernels sum in float64 in a fixed order: the iterates equal the eager
loop's to rounding, and two runs give bitwise the same. The caller passes
an epilogue only where the dot products need no reduction across ranks.

Spans (utils/profiling.py; no-ops unless a trace is on): every operator
application is a `pcg.apply`, every eager preconditioner application a
`pcg.precond`, the host read of `run` a `pcg.check`, and the rest of the
loop's launches (dots, scalar and vector updates; the epilogue's kernels)
`pcg.update`. The condition `run` of the next iteration is formed at the
end of the body, inside the same `pcg.update` as the updates it reads. With
a Jacobi epilogue no `pcg.precond` opens inside the loop: the divide is
folded into cg_xr and cg_p.

Stopping rule, exactly the reference's: iterate while rr > tol2 and
k < maxiter and gamma > 0 and bnorm2 > 0, with tol2 = max(rtol·||b||,
atol)^2, and alpha = 0 where pAp <= 0.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pynama_tpu_torch.ops import cg_epilogue as E
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
        check_every: int = 8, dots: Callable | None = None,
        epilogue: E.Epilogue | None = None) -> CGResult:
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

    epilogue, when given, runs the loop through ops/cg_epilogue.py (see the
    module docstring). Its operator `free * epilogue.apply(v)` must equal
    A. Its `dmask`, where given, must be the divisor of a pointwise M_inv;
    otherwise the loop calls M_inv. Its `inv_mult`-weighted dot products
    must be those of `dot` and `dots`. The prologue still takes A0, M_inv
    and dots. Without it the loop is written in the same step functions
    (ops/cg_epilogue.py alpha_step, xr_step, scalar_step, p_step) that the
    epilogue's plain versions run.
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
        live = bnorm2 > 0            # loop-invariant part of the condition
        run = (rr > tol2) & (k < maxiter) & (gamma > 0) & live
    if epilogue is not None:
        return _fused_loop(epilogue, M_inv, x0, r, z, gamma, rr, tol2, live,
                           run, k, maxiter, check_every)

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
            _, alpha = E.alpha_step(p, Ap, gamma, run, dot)
            x, r = E.xr_step(x, r, p, Ap, alpha)
        with span("pcg.precond"):
            z = M_inv(r)
        with span("pcg.update"):
            beta, gamma, rr, k, run = E.scalar_step(
                r, z, gamma, rr, k, run, tol2, live, maxiter, dots)
            p = E.p_step(z, p, beta)
        n += 1
    with span("pcg.update"):
        x = torch.where(live, x, torch.zeros_like(x))
        residual = torch.sqrt(rr)
    return CGResult(x=x, iters=k, residual=residual, loop_applies=n)


def _fused_loop(ep: E.Epilogue, M_inv, x0, r, z, gamma, rr, tol2, live, run,
                k, maxiter: int, check_every: int) -> CGResult:
    """pcg's loop through the epilogue's steps, from the prologue's
    values."""
    with span("pcg.update"):
        st = E.CGState(ep, x0, r, z, gamma, rr, tol2, live, run, k, maxiter)
    pointwise = ep.dmask is not None
    n = 0
    while n < maxiter:
        if n % check_every == 0:
            with span("pcg.check"):
                stop = not st.running()
            if stop:
                break
        with span("pcg.apply"):
            y = ep.apply(st.p)
        with span("pcg.update"):
            ap = E.cg_pap(st, y)
            E.cg_xr(st, ap)
            if pointwise:
                E.cg_p(st)
        if not pointwise:
            with span("pcg.precond"):
                z = M_inv(st.r)
            with span("pcg.update"):
                E.cg_rz(st, z)
                E.cg_p(st, z)
        n += 1
    with span("pcg.update"):
        x, iters, residual = st.result()
    return CGResult(x=x, iters=iters, residual=residual, loop_applies=n)
