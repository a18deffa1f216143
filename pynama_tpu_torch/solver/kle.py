"""KLE velocity solver in the global layout: masked matrix-free K with CG
or GMRES, or a dense Cholesky factor.

Port of pynama_tpu/solver/kle.py. One raw operator pair (K_raw, Rw_raw)
and per-solve free/constrained dof masks replace the reference's
Dirichlet-condensed matrix zoo:

    K      x = Rw w + Krhs v_bc      <=>   with c = 1-free:
    [free] A[free,free] x_f = (Rw_raw w)_f - (K_raw c*v_bc)_f ; x_c = v_bc

For no-slip problems the free-slip stage solve is the same equation with a
wider free mask (interior + wall-tangential dofs).

Solvers: 'cg' (Jacobi-preconditioned matrix-free PCG), 'gmres' (restarted
Jacobi-preconditioned GMRES(30)), or 'direct' (setup-time dense Cholesky of
the masked operator, the twin of the reference's `-ksp_type preonly
-pc_type lu`).

The direct setup assembles the dense masked K on the host in numpy float64,
as the JAX package does, and factors it with `torch.linalg.cholesky` in
float64 on the Problem's device (cuSOLVER on a GPU, LAPACK on the CPU); the
factor is then cast to the runtime dtype and the float64 matrices are
freed. The JAX package factors on the host with scipy: at 20,402 dofs that
took 7.8 s of an 8-core host against 0.67 s for copy, device factor and
cast on an H100 (`tools/direct_factor_routes.py`). Each solve is two
triangular solves with the factor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from pynama_tpu_torch.ops.apply import (ElementOp, apply_op,
                                        assembled_diagonal_np,
                                        assemble_dense)
from pynama_tpu_torch.solver.cg import pcg
from pynama_tpu_torch.solver.gmres import gmres
from pynama_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class KLESystem:
    """One masked linear system K-masked x = Rw-masked w + bc terms."""
    free: torch.Tensor                   # (n_nodes, dim) 1.0 free / 0.0 bc
    diag: torch.Tensor                   # (n_nodes, dim) diag of masked K
    chol: Optional[torch.Tensor]         # dense lower Cholesky factor
    method: str
    cg_rtol: float
    cg_atol: float
    cg_maxiter: int
    #: host seconds of the direct setup: "assemble" (numpy dense masked K)
    #: and "factor" (the device Cholesky and the cast); empty otherwise
    setup_s: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class KLESolver:
    K_op: ElementOp
    Rw_op: ElementOp
    main: KLESystem
    fs: Optional[KLESystem]   # free-slip stage for no-slip problems

    @property
    def is_ns(self) -> bool:
        return self.fs is not None

    # -- solves ------------------------------------------------------------
    def solve(self, vort, vel, stats=None):
        """Main KLE solve. `vel` carries the boundary values on constrained
        dofs and serves as the iterative warm start. `stats`, when a list,
        gets the solve's (iterations, operator applications) (see
        _masked_solve)."""
        return _masked_solve(self.K_op, self.Rw_op, self.main, vort, vel,
                             stats)

    def solve_fs(self, vort, vel, stats=None):
        """Free-slip stage solve for NS problems."""
        return _masked_solve(self.K_op, self.Rw_op, self.fs, vort, vel,
                             stats, stage="fs")


def _masked_solve(K_op: ElementOp, Rw_op: ElementOp, sys: KLESystem,
                  vort, vel, stats=None, stage="main"):
    """Solve one masked system. `stats`, when a list, gets one pair per
    iterative solve: (iters, loop_applies) for cg (the A0 residual not
    counted, as in CGResult), (iters, applies) for gmres (every
    application counted, as in GMRESResult). The solve is a `kle.solve`
    span with attrs method and stage ("fs" or "main"), and for an
    iterative solve loop_applies (the count above, a host int) and iters
    (a device tensor); a cg solve also epilogue, as pcg reports it
    (CGResult.epilogue): "eager", since the system is given generically
    (plain steps on every device)."""
    with span("kle.solve") as sp:
        sp.attrs["method"], sp.attrs["stage"] = sys.method, stage
        free = sys.free
        con = 1.0 - free
        vc = con * vel
        b = free * (apply_op(Rw_op, vort) - apply_op(K_op, vc)) + vc

        if sys.method == "direct":
            # two triangular solves, not torch.cholesky_solve: that copies
            # the whole factor on every call (1.66 GB at 20,402 dofs in f32,
            # +40% time; tools/direct_factor_routes.py), same result bit for
            # bit
            y = torch.linalg.solve_triangular(sys.chol, b.reshape(-1, 1),
                                              upper=False)
            x = torch.linalg.solve_triangular(sys.chol.mT, y, upper=True)
            return x.reshape(vel.shape)

        def A0(v):
            """Full condensed operator — initial residual only (and
            GMRES)."""
            return free * apply_op(K_op, free * v) + con * v

        def A(v):
            """In-loop operator: CG loop vectors are exactly zero on the
            constrained dofs (ops/cg_epilogue.py MaskedSystem),
            so the input mask and `con*v` passthrough are dropped, with a
            bitwise-identical trajectory."""
            return free * apply_op(K_op, v)

        dmask = free * sys.diag + con

        def M_inv(r):
            return r / dmask

        x0 = free * vel + vc
        if sys.method == "gmres":
            res = gmres(A0, b, x0, M_inv=M_inv, rtol=sys.cg_rtol,
                        atol=sys.cg_atol, maxiter=sys.cg_maxiter)
            counted = res.applies
        else:
            res = pcg(A, b, x0, M_inv=M_inv, rtol=sys.cg_rtol,
                      atol=sys.cg_atol, maxiter=sys.cg_maxiter, A0=A0)
            sp.attrs["epilogue"] = res.epilogue
            counted = res.loop_applies
        sp.attrs["loop_applies"], sp.attrs["iters"] = counted, res.iters
    if stats is not None:
        stats.append((res.iters, counted))
    return res.x


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

def build_system(K_mat_np: np.ndarray, cell_nodes: np.ndarray,
                 free_mask_np: np.ndarray, K_op: ElementOp, method: str,
                 cg_rtol: float, cg_atol: float, cg_maxiter: int, *,
                 device, dtype) -> KLESystem:
    """Build one masked system; for 'direct', assemble on the host, factor
    on `device` in float64, keep the factor in `dtype` only."""
    n_nodes, dim = free_mask_np.shape
    free = torch.as_tensor(free_mask_np.astype(np.float64), dtype=dtype,
                           device=device)
    diag = torch.as_tensor(
        assembled_diagonal_np(K_mat_np, cell_nodes, n_nodes), dtype=dtype,
        device=device)
    chol = None
    setup_s = {}
    if method == "direct":
        t0 = time.perf_counter()
        A = assemble_dense(K_mat_np, cell_nodes, dim, dim, n_nodes)
        f = free_mask_np.ravel().astype(bool)
        c = ~f
        A[c, :] = 0.0
        A[:, c] = 0.0
        A[c, c] = 1.0
        t1 = time.perf_counter()
        A_dev = torch.as_tensor(A, device=device)
        del A
        # raises unless A_dev is positive definite (it reads the status
        # back, so the factor is complete when the call returns)
        chol = torch.linalg.cholesky(A_dev)
        del A_dev
        chol = chol.to(dtype)
        setup_s = {"assemble": t1 - t0, "factor": time.perf_counter() - t1}
    return KLESystem(free=free, diag=diag, chol=chol, method=method,
                     cg_rtol=float(cg_rtol), cg_atol=float(cg_atol),
                     cg_maxiter=int(cg_maxiter), setup_s=setup_s)
