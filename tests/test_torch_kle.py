"""Port parity: pynama_tpu_torch.solver.kle (KLESolver, build_system)
against pynama_tpu.solver.kle, float64 on the CPU.

A random dense SPD K (tests/test_cg_loop.py's `_random_spd`) becomes one
global ElementOp of a single element covering every node (one component
per node; Rw the identity, so the rhs is the vorticity argument). Through
the port's KLESolver:
- the A0/A split of the CG loop matches the fully masked solve, iteration
  count included, to f64 round-off, and leaves the constrained dofs at the
  boundary values exactly (tests/test_cg_loop.py's cases);
- cg, gmres and direct agree with each other and with the JAX package's
  KLESolver;
- build_system's direct factor equals the JAX package's scipy factor, and
  in float32 only the float32 factor is kept.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.ops.apply import make_element_op as j_make_op
from pynama_tpu.solver import kle as JK
from pynama_tpu_torch.ops.apply import make_element_op
from pynama_tpu_torch.solver import kle as TK
from pynama_tpu_torch.solver.cg import pcg

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-12


def _random_spd(n, rng, cond=1e4):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.geomspace(1.0, cond, n)
    return (Q * lam) @ Q.T


def _case(n, n_con, seed):
    """(K, free mask (n, 1), vel, rhs) of one masked system."""
    rng = np.random.default_rng(seed)
    K = _random_spd(n, rng)
    free = np.ones((n, 1))
    if n_con:
        free[rng.choice(n, size=n_con, replace=False)] = 0.0
    return K, free, rng.standard_normal((n, 1)), rng.standard_normal((n, 1))


def _solver(K, free, method, pkg="torch", dtype=F64, fs=False):
    """A KLESolver of the one-element operator K (both systems the same
    when fs)."""
    n = K.shape[0]
    cn = np.arange(n)[None, :]
    inc = np.arange(n)[:, None]
    args = dict(K_mat_np=K, cell_nodes=cn, free_mask_np=free, method=method,
                cg_rtol=RTOL, cg_atol=0.0, cg_maxiter=500)
    if pkg == "torch":
        mk = lambda m: make_element_op(m, cn, inc, 1, 1, n, device="cpu",
                                       dtype=dtype)
        K_op = mk(K)
        sys = TK.build_system(K_op=K_op, device="cpu", dtype=dtype, **args)
        return TK.KLESolver(K_op=K_op, Rw_op=mk(np.eye(n)), main=sys,
                            fs=sys if fs else None)
    mk = lambda m: j_make_op(m, cn, inc, 1, 1, n)
    K_op = mk(K)
    sys = JK.build_system(K_op=K_op, dtype=jnp.float64, **args)
    return JK.KLESolver(K_op=K_op, Rw_op=mk(np.eye(n)), main=sys, fs=None)


@pytest.mark.parametrize("n_con", [0, 7])
def test_a0_split_matches_full_masked_solve(n_con):
    K, free_np, vel_np, rhs_np = _case(60, n_con, 3)
    s = _solver(K, free_np, "cg")
    vel, rhs = torch.as_tensor(vel_np), torch.as_tensor(rhs_np)
    stats = []
    x = s.solve(rhs, vel, stats)
    # the fully masked solve, with no A0/A split
    Kt = torch.as_tensor(K)
    free = torch.as_tensor(free_np)
    con = 1.0 - free
    vc = con * vel
    b = free * (rhs - Kt @ vc) + vc
    dmask = free * torch.diagonal(Kt)[:, None] + con
    ref = pcg(lambda v: free * (Kt @ (free * v)) + con * v, b,
              free * vel + vc, M_inv=lambda r: r / dmask, rtol=RTOL,
              maxiter=500)
    assert int(stats[0][0]) == int(ref.iters) > 0
    np.testing.assert_allclose(x.numpy(), ref.x.numpy(), rtol=1e-12,
                               atol=1e-12)
    c = free_np == 0
    np.testing.assert_array_equal(x.numpy()[c], vel_np[c])


def test_loop_iterates_stay_zero_on_constrained():
    """The invariant itself: the final residual of the split solve is zero
    on the constrained dofs."""
    K, free_np, vel_np, rhs_np = _case(40, 9, 5)
    s = _solver(K, free_np, "cg")
    vel, rhs = torch.as_tensor(vel_np), torch.as_tensor(rhs_np)
    x = s.solve(rhs, vel)
    Kt, free = torch.as_tensor(K), torch.as_tensor(free_np)
    con = 1.0 - free
    vc = con * vel
    b = free * (rhs - Kt @ vc) + vc
    r = (b - (free * (Kt @ (free * x)) + con * x)).numpy()
    assert np.max(np.abs(r[free_np == 0])) == 0.0


@pytest.mark.parametrize("method", ["direct", "cg", "gmres"])
@pytest.mark.parametrize("n_con", [0, 7])
def test_solvers_match_jax(method, n_con):
    K, free_np, vel_np, rhs_np = _case(50, n_con, 7)
    xt = _solver(K, free_np, method).solve(torch.as_tensor(rhs_np),
                                           torch.as_tensor(vel_np)).numpy()
    xj = np.asarray(_solver(K, free_np, method, "jax").solve(
        jnp.asarray(rhs_np), jnp.asarray(vel_np)))
    xd = np.asarray(_solver(K, free_np, "direct", "jax").solve(
        jnp.asarray(rhs_np), jnp.asarray(vel_np)))
    scale = np.abs(xd).max()
    assert np.abs(xt - xj).max() <= 1e-10 * scale
    assert np.abs(xt - xd).max() <= 1e-8 * scale


def test_build_system_direct_matches_jax():
    K, free_np, _, _ = _case(30, 5, 11)
    t = _solver(K, free_np, "direct").main
    j = _solver(K, free_np, "direct", "jax").main
    np.testing.assert_array_equal(t.free.numpy(), np.asarray(j.free))
    np.testing.assert_allclose(t.diag.numpy(), np.asarray(j.diag),
                               rtol=1e-14)
    scale = np.abs(np.asarray(j.chol)).max()
    assert np.abs(t.chol.numpy() - np.asarray(j.chol)).max() <= 1e-12 * scale
    assert set(t.setup_s) == {"assemble", "factor"}
    assert (t.method, t.cg_maxiter) == (j.method, j.cg_maxiter)


def test_direct_float32_keeps_one_factor():
    """In float32 the factor is float32 (the float64 matrices are gone),
    lower triangular, and the solve reaches the float64 one to f32
    accuracy; cg systems carry no factor."""
    K, free_np, vel_np, rhs_np = _case(40, 6, 13)
    s32 = _solver(K, free_np, "direct", dtype=torch.float32, fs=True)
    assert s32.main.chol.dtype == torch.float32 and s32.is_ns
    assert not torch.triu(s32.main.chol, 1).any()
    x32 = s32.solve_fs(torch.as_tensor(rhs_np, dtype=torch.float32),
                       torch.as_tensor(vel_np, dtype=torch.float32))
    x64 = _solver(K, free_np, "direct").solve(torch.as_tensor(rhs_np),
                                              torch.as_tensor(vel_np))
    assert x32.dtype == torch.float32
    assert (x32.double() - x64).abs().max() <= 1e-3 * x64.abs().max()
    s = _solver(K, free_np, "cg")
    assert s.main.chol is None and s.main.setup_s == {} and not s.is_ns
