"""Port parity: pynama_tpu_torch.solver.gmres against pynama_tpu's GMRES,
float64 on the CPU.

The systems of tests/test_gmres.py (SPD, non-symmetric through several
restart cycles, Jacobi-preconditioned with (n, 2)-shaped unknowns) go
through both: equal Arnoldi step counts, iterates to 1e-10, and the
reference's tolerances against numpy's dense solve. Then the edge cases
the JAX version handles by construction: exact breakdown (a Krylov space
smaller than the restart length; unit diagonal, zero rhs), a zero rhs (no
iteration), maxiter across restarts, and a pluggable weighted dot.
"""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from pynama_tpu.solver.gmres import gmres as jgmres
from pynama_tpu_torch.solver.gmres import gmres

torch.set_num_threads(1)


def _both(A, b, x0=None, M_diag=None, shape=None, **kw):
    """(port result, JAX result) of one system, A dense (n, n); b in
    `shape` (default b's own)."""
    shape = b.shape if shape is None else shape
    x0 = np.zeros(shape) if x0 is None else x0
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    mt = mj = None
    if M_diag is not None:
        dt, dj = torch.as_tensor(M_diag), jnp.asarray(M_diag)
        mt = lambda r: (r.reshape(-1) / dt).reshape(shape)
        mj = lambda r: (r.ravel() / dj).reshape(shape)
    rt = gmres(lambda v: (At @ v.reshape(-1)).reshape(shape),
               torch.as_tensor(b), torch.as_tensor(x0), M_inv=mt, **kw)
    rj = jgmres(lambda v: (Aj @ v.ravel()).reshape(shape), jnp.asarray(b),
                jnp.asarray(x0), M_inv=mj, **kw)
    return rt, rj


def _agree(rt, rj, tol=1e-10):
    assert rt.iters == int(rj.iters)
    scale = np.abs(np.asarray(rj.x)).max()
    assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() <= tol * scale


def test_gmres_spd():
    rng = np.random.default_rng(0)
    n = 40
    B = rng.standard_normal((n, n))
    A = B @ B.T + n * np.eye(n)
    b = rng.standard_normal(n)
    rt, rj = _both(A, b, rtol=1e-12)
    _agree(rt, rj)
    npt.assert_allclose(rt.x.numpy(), np.linalg.solve(A, b), rtol=1e-8,
                        atol=1e-10)
    # one application for r0, one per restart cycle, one per Arnoldi step
    assert rt.applies == rt.iters + 2


def test_gmres_nonsymmetric_restarted():
    """Non-symmetric system, forced through multiple restart cycles."""
    rng = np.random.default_rng(1)
    n = 90
    A = np.eye(n) + 0.4 * rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    rt, rj = _both(A, b, rtol=1e-12, restart=20, maxiter=500)
    _agree(rt, rj)
    assert rt.iters > 20
    cycles = -(-rt.iters // 20)
    assert rt.applies == 1 + cycles + rt.iters
    npt.assert_allclose(rt.x.numpy(), np.linalg.solve(A, b), rtol=1e-7,
                        atol=1e-9)
    assert rt.residual == pytest.approx(float(rj.residual), rel=1e-6)


def test_gmres_preconditioned_2d_shape():
    """Left preconditioning + (n, dim)-shaped unknowns (the KLE layout)."""
    rng = np.random.default_rng(2)
    n = 30
    B = rng.standard_normal((2 * n, 2 * n))
    A = B @ B.T + 2 * n * np.eye(2 * n)
    b = rng.standard_normal((n, 2))
    rt, rj = _both(A, b, M_diag=np.diag(A).copy(), rtol=1e-12)
    _agree(rt, rj)
    assert rt.x.shape == (n, 2)
    npt.assert_allclose(rt.x.numpy().ravel(), np.linalg.solve(A, b.ravel()),
                        rtol=1e-8, atol=1e-10)


def test_gmres_small_krylov_space():
    """Three distinct eigenvalues: the Krylov space is exhausted after 3
    steps, well inside a cycle; the solve is exact and the iterate equals
    the JAX version's."""
    rng = np.random.default_rng(3)
    n = 12
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.repeat([1.0, 2.0, 5.0], 4)) @ Q.T
    b = rng.standard_normal(n)
    rt, rj = _both(A, b, rtol=1e-14, maxiter=50)
    _agree(rt, rj)
    assert rt.iters <= 4
    npt.assert_allclose(rt.x.numpy(), np.linalg.solve(A, b), rtol=1e-10,
                        atol=1e-12)


def test_gmres_exact_breakdown():
    """The nilpotent A = [[0, 1], [0, 0]] with b = e0: A V0 = 0, so the
    first Hessenberg column is exactly zero (denom == 0). The guard (unit
    diagonal, zero rhs) leaves x unchanged, finite and equal to the JAX
    version's, and the loop stops with a zero residual estimate."""
    A = np.array([[0.0, 1.0], [0.0, 0.0]])
    rt, rj = _both(A, np.array([1.0, 0.0]), rtol=1e-12, maxiter=10)
    assert rt.iters == int(rj.iters) == 1
    npt.assert_array_equal(rt.x.numpy(), np.asarray(rj.x))
    assert not rt.x.numpy().any()
    assert rt.residual == float(rj.residual) == 0.0


def test_gmres_zero_rhs():
    """b = 0 from x0 = 0: the tolerance is 0 and the residual 0, so no
    step is taken and x stays 0 (as in the JAX version)."""
    A = np.diag(np.arange(1.0, 6.0))
    rt, rj = _both(A, np.zeros(5), rtol=1e-12)
    assert rt.iters == int(rj.iters) == 0 and rt.applies == 1
    assert not rt.x.numpy().any()


def test_gmres_maxiter_caps_total_steps():
    rng = np.random.default_rng(4)
    n = 60
    A = np.eye(n) + 0.9 * rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    rt, rj = _both(A, b, rtol=1e-14, restart=10, maxiter=25)
    _agree(rt, rj)
    assert rt.iters == 25 and rt.residual > 0


def test_gmres_weighted_dot_and_float32():
    """A pluggable inner product (the engine's ownership-weighted dot), and
    float32: the same step count as the JAX version in float32."""
    rng = np.random.default_rng(5)
    n = 32
    B = rng.standard_normal((n, n))
    A = B @ B.T + n * np.eye(n)
    b = rng.standard_normal(n)
    w = rng.uniform(0.5, 1.5, n)
    wt, wj = torch.as_tensor(w), jnp.asarray(w)
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    rt = gmres(lambda v: At @ v, torch.as_tensor(b), torch.zeros(n,
               dtype=torch.float64), rtol=1e-12,
               dot=lambda x, y: (x * y * wt).sum())
    rj = jgmres(lambda v: Aj @ v, jnp.asarray(b), jnp.zeros(n), rtol=1e-12,
                dot=lambda x, y: (x * y * wj).sum())
    _agree(rt, rj)
    f32 = torch.float32
    A32, b32 = At.to(f32), torch.as_tensor(b, dtype=f32)
    rt = gmres(lambda v: A32 @ v, b32, torch.zeros(n, dtype=f32), rtol=1e-5)
    rj = jgmres(lambda v: jnp.asarray(A, jnp.float32) @ v,
                jnp.asarray(b, jnp.float32), jnp.zeros(n, jnp.float32),
                rtol=1e-5)
    assert rt.x.dtype == f32 and rt.iters == int(rj.iters)
    npt.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-4,
                        atol=1e-6)
