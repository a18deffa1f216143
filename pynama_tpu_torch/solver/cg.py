"""Preconditioned conjugate gradients with a device-side stopping flag.

Port of pynama_tpu/solver/cg.py. The JAX version runs the loop under
`lax.while_loop`, whose condition is evaluated on the device. Eager PyTorch
would need a host sync per iteration to test it. Instead the loop keeps the
reference's condition as a device flag `run` and folds it into the update:
once `run` is false, alpha and beta are zero and the scalars stay frozen,
so x and r never change again. The host reads `run` only every
CHECK_EVERY iterations and then stops. The iterate and the iteration count
are those of the reference; the cost is up to CHECK_EVERY - 1 operator
applications after convergence, against one host sync per iteration
saved.

One loop: each iteration applies the operator and runs the steps of
ops/cg_epilogue.py on the solve's CGState: cg_pap, cg_xr, then, where the
preconditioner is not pointwise, an eager M_inv and cg_rz, then cg_p. The
state runs the steps as hand-written CUDA kernels, which keep every CG
scalar on the card, where its vectors are on a card and the system is a
MaskedSystem on one rank, and as plain PyTorch otherwise (see that
module). The prologue (the first residual, tol2, live), the stop checks
and the counts are pcg's own on every route.

Spans (utils/profiling.py; no-ops unless a trace is on): every operator
application is a `pcg.apply`, every eager preconditioner application a
`pcg.precond`, the host read of `run` a `pcg.check`, and the rest of the
loop's work (dots, scalar and vector updates; the kernels) `pcg.update`.
The condition `run` of the next iteration is formed at the end of the
body, inside the same `pcg.update` as the updates it reads. With a Jacobi
divisor no `pcg.precond` opens inside the loop: the divide is folded into
cg_xr and cg_p.

Stopping rule, exactly the reference's: iterate while rr > tol2 and
k < maxiter and gamma > 0 and bnorm2 > 0, with tol2 = max(rtol·||b||,
atol)^2, and alpha = 0 where pAp <= 0.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pynama_tpu_torch.ops import cg_epilogue as E
from pynama_tpu_torch.utils.profiling import span

#: iterations between two host reads of the loop's condition
CHECK_EVERY = 8


class CGResult(NamedTuple):
    x: torch.Tensor
    #: iterations the reference loop would run (0-d int tensor, on device)
    iters: torch.Tensor
    residual: torch.Tensor
    #: operator applications the loop actually made (host int, >= iters)
    loop_applies: int
    #: "fused": the system was a MaskedSystem on one rank, whose steps run
    #: as the kernels on a card (as plain steps on the CPU); "eager": a
    #: sharded masked system or a generic one, plain steps everywhere
    epilogue: str


def vdot(a, b):
    """The plain sum of products: the default dot of pcg and gmres."""
    return (a * b).sum()


def pcg(A: Callable | E.MaskedSystem, b: torch.Tensor, x0: torch.Tensor,
        M_inv: Callable | None = None, rtol: float = 1e-12,
        atol: float = 0.0, maxiter: int = 1000,
        dot: Callable | None = None, A0: Callable | None = None
        ) -> CGResult:
    """Solve A x = b with preconditioned CG.

    Generic form, the JAX package's: A and M_inv are linear callables on
    tensors of b's shape, dot the inner product (default: the plain sum of
    products). A0, when given, is used ONLY for the initial residual r0 =
    b - A0(x0): the caller guarantees A(v) == A0(v) for every vector the
    loop produces. Stopping: ||r|| <= max(rtol * ||b||, atol) in dot's
    norm, capped at maxiter iterations.

    A may instead be an ops/cg_epilogue.py MaskedSystem, from which pcg
    derives the loop's operator, A0, M_inv and the dot products (M_inv, dot
    and A0 are then left None): the Dirichlet-condensed KLE system of
    engine/local_engine.py _masked_solve.

    The benchmark wraps this function under the module-level names
    `engine.local_engine.pcg` and `solver.kle.pcg`, so callers there call
    it through those names.
    """
    if isinstance(A, E.MaskedSystem):
        if M_inv is not None or dot is not None or A0 is not None:
            raise TypeError("pcg derives M_inv, dot and A0 from a "
                            "MaskedSystem")
        system = A
    else:
        system = E.System(A, (lambda r: r) if M_inv is None else M_inv,
                       vdot if dot is None else dot,
                       A if A0 is None else A0)

    with span("pcg.apply"):
        r = system.A0(x0)
    with span("pcg.update"):
        r = b - r                # frees A x0: no vector outlives its use
    with span("pcg.precond"):
        z = system.M_inv(r)
    with span("pcg.update"):
        gamma, rr, bnorm2 = system.dots([(r, z), (r, r), (b, b)])
        tol2 = torch.clamp(rtol * torch.sqrt(bnorm2), min=atol) ** 2
        k = torch.zeros((), dtype=torch.int64, device=b.device)
        live = bnorm2 > 0            # loop-invariant part of the condition
        run = (rr > tol2) & (k < maxiter) & (gamma > 0) & live
        st = E.CGState(system, x0, r, z, gamma, rr, tol2, live, run, k,
                       maxiter)
    pointwise = st.dmask is not None
    n = 0
    while n < maxiter:
        if n % CHECK_EVERY == 0:
            with span("pcg.check"):
                stop = not st.running()
            if stop:
                break
        with span("pcg.apply"):
            y = system.apply(st.p)
        with span("pcg.update"):
            E.cg_xr(st, E.cg_pap(st, y))
            if pointwise:
                E.cg_p(st)
        if not pointwise:
            with span("pcg.precond"):
                z = system.M_inv(st.r)
            with span("pcg.update"):
                E.cg_rz(st, z)
                E.cg_p(st, z)
        n += 1
    with span("pcg.update"):
        x, iters, residual = st.result()
    return CGResult(x=x, iters=iters, residual=residual, loop_applies=n,
                    epilogue="fused" if st.fused else "eager")
