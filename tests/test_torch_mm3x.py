"""Port parity: pynama_tpu_torch.exp.mm3x (K2 fused3x_apply, mm3x_ref and
the driver) against the JAX package's exp/mm3x.py.

The JAX kernel runs in Pallas interpret mode (the loaded module's `pl` is
monkeypatched; nothing in exp/ changes). On CPU tensors the port's wrapper
runs its plain PyTorch version and its launch counter stays at 0; the CUDA
kernel needs the card and is checked by chip_smoke.py. All in float32.
Tolerances, relative to max|ref|:
- port against JAX, 2e-6: both compute the same split products, exact in
  f32; only the summation order of the two CPU GEMMs differs (measured
  <= 6e-7);
- the split against the exact float64 product, 2^-16: the split keeps 16
  mantissa bits of each factor, the dropped lo*lo term and the rounding of
  the lo halves are each below 2^-17 of a product (measured <= 6e-6);
- K2 against the full-f32 fused_apply, 5e-5: the split's own error with
  margin;
- the CUDA GEMM's summation order in numpy (mm3x_chained: 32-deep chains
  added in f32) against mm3x_ref and JAX's _mm3x, 2e-6: the same exact
  products, summed in another order (measured <= 5e-7).

gemm3x_plan restates what csrc/fused3x.cu decides on the host; chip_smoke.py
holds it against the library's own answer on the card. Here its invariants
are checked at every (K, N) the engine gives the GEMM.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynama_tpu_torch.exp import mm3x as M
from pynama_tpu_torch.ops.fused import fused_apply

from test_torch_decomp import (CONFIGS, _dup_consistent, _inputs, _rel,
                               interpret_pl, load_jax_exp)

torch.set_num_threads(1)

SHAPES = [(192, 192), (192, 384), (384, 192), (9, 18)]    # (nnc_in, nnc_out)
# every (K, N) the engine gives the GEMM: 3D ngl=4 and ngl=7, 2D ngl=3, and
# the degenerate meshes of chip_smoke.py's SHAPES
ENGINE_KN = [(192, 192), (192, 384), (384, 192), (1029, 1029), (1029, 2058),
             (2058, 1029), (18, 18), (9, 18), (18, 9), (18, 27), (27, 18),
             (81, 27), (24, 24)]
PLAN_M = [1, 63, 64, 127, 129, 13824]


@pytest.fixture(scope="module")
def jexp():
    return load_jax_exp("mm3x")


@pytest.fixture
def jx(jexp, monkeypatch):
    monkeypatch.setattr(jexp, "pl", interpret_pl())
    return jexp


def _f32(*arrays):
    return tuple(np.asarray(a, dtype=np.float32) for a in arrays)


def _matrices(nin, nout, rows=576):
    rng = np.random.default_rng(7 * nin + nout)
    return _f32(rng.standard_normal((rows, nin)),
                rng.standard_normal((nin, nout)))


@pytest.mark.parametrize("nin,nout", SHAPES)
def test_mm3x_ref_matches_jax(jexp, nin, nout):
    a, m = _matrices(nin, nout)
    yj = jexp._mm3x(jnp.asarray(a), jnp.asarray(m), jnp.float32)
    yt = M.mm3x_ref(torch.as_tensor(a), torch.as_tensor(m))
    assert yt.dtype == torch.float32 and yt.shape == yj.shape
    assert _rel(yt.numpy(), yj) <= 2e-6


@pytest.mark.parametrize("nin,nout", SHAPES)
def test_mm3x_split_error(nin, nout):
    a, m = _matrices(nin, nout)
    exact = a.astype(np.float64) @ m.astype(np.float64)
    y = M.mm3x_ref(torch.as_tensor(a), torch.as_tensor(m)).numpy()
    assert _rel(y, exact) <= 2.0 ** -16


def test_split_halves_bitwise_equal():
    """torch's and JAX's bf16 round-to-nearest-even agree bit for bit."""
    a, _ = _matrices(192, 192)
    aj = jnp.asarray(a)
    hj = aj.astype(jnp.bfloat16).astype(jnp.float32)
    lj = (aj - hj).astype(jnp.bfloat16).astype(jnp.float32)
    at = torch.as_tensor(a)
    ht = at.to(torch.bfloat16).float()
    lt = (at - ht).to(torch.bfloat16).float()
    np.testing.assert_array_equal(ht.numpy().view(np.uint32),
                                  np.asarray(hj).view(np.uint32))
    np.testing.assert_array_equal(lt.numpy().view(np.uint32),
                                  np.asarray(lj).view(np.uint32))


@pytest.mark.parametrize("block", ["one", "ne0"])
@pytest.mark.parametrize("nelem,ngl,cin,cout", CONFIGS)
def test_fused3x_matches_jax(jx, nelem, ngl, cin, cout, block):
    blk = 1 if block == "one" else nelem[0]
    t, m = _f32(*_inputs(nelem, ngl, cin, cout))
    yj = jx.fused3x_apply(jnp.asarray(t), jnp.asarray(m), tuple(nelem), ngl,
                          cout, block=blk)
    yt = M.fused3x_apply(torch.as_tensor(t), torch.as_tensor(m), nelem, ngl,
                         cout, blk)
    assert M.fused3x_apply.launches == 0        # CPU: the plain version
    assert yt.dtype == torch.float32 and yt.shape == yj.shape
    assert _rel(yt.numpy(), yj) <= 2e-6


@pytest.mark.parametrize("nelem,ngl,cin,cout", CONFIGS)
def test_fused3x_against_fused_apply(nelem, ngl, cin, cout):
    t, m = (torch.as_tensor(a) for a in _f32(*_inputs(nelem, ngl, cin, cout,
                                                      13)))
    y3 = M.fused3x_apply(t, m, nelem, ngl, cout, 2)
    yf, _ = fused_apply(t, m, nelem, ngl, cout)
    assert _rel(y3.numpy(), yf.numpy()) <= 5e-5
    assert _dup_consistent(y3, nelem, ngl, cout)


@pytest.mark.parametrize("fn", [M.fused3x_apply, M.fused3x_apply_ref],
                         ids=["kernel", "ref"])
def test_fused3x_rejects_float64(fn):
    t, m = (torch.as_tensor(a) for a in _inputs((4, 3), 3, 1, 2))
    with pytest.raises(TypeError, match="float32 only"):
        fn(t, m, (4, 3), 3, 2, 1)


@pytest.mark.parametrize("fn", [M.fused3x_apply, M.fused3x_apply_ref],
                         ids=["kernel", "ref"])
def test_fused3x_block_must_divide(fn):
    t, m = (torch.as_tensor(a) for a in _f32(*_inputs((4, 3), 3, 1, 2)))
    with pytest.raises(ValueError, match="does not divide"):
        fn(t, m, (4, 3), 3, 2, 3)


def test_mm3x_driver_runs(capsys):
    out = M.main(["3", "3", "--nit", "4", "--rounds", "1", "--device",
                  "cpu"])
    text = capsys.readouterr().out
    assert text.startswith("device: cpu;")
    assert "3x vs HIGHEST: max abs diff" in text and "round 0:" in text
    assert out["max_abs_diff"] <= 5e-5 * out["scale"]
    assert set(out["times"]) == {"fused_HI", "fused_3x", "mm_HI"}
    assert M.fused3x_apply.launches == 0


@pytest.mark.parametrize("rows", PLAN_M)
@pytest.mark.parametrize("K,N", ENGINE_KN)
def test_gemm3x_plan(rows, K, N):
    p = M.gemm3x_plan(rows, K, N)
    bn, kp, np_ = p["tile_n"], p["kp"], p["np"]
    # whole stages and tiles cover K and N with less than one to spare
    assert kp % M.X_BK == 0 and 0 <= kp - K < M.X_BK
    assert bn in (32, 192) and np_ == p["ncol"] * bn and 0 <= np_ - N < bn
    assert (bn == 32) == (N <= 32)
    # wgmma takes N / 2 a multiple of 8 per warpgroup, at most 256
    assert (bn // 2) % 8 == 0 and bn // 2 <= 256
    # resident exactly where both halves of the slab fit beside the ring
    slab = 2 * 2 * kp * bn
    fits = slab + M.X_STAGES_RES * M.X_A_STAGE <= M.X_SMEM_MAX
    assert p["resident"] == int(fits)
    assert p["stages"] == (M.X_STAGES_RES if fits else M.X_STAGES_STR)
    stage = M.X_A_STAGE + (0 if fits else 2 * 2 * M.X_BK * bn)
    assert p["smem_bytes"] == p["stages"] * stage + (slab if fits else 0)
    assert p["smem_bytes"] <= M.X_SMEM_MAX
    # the ring holds at least the two stages in use and one in flight
    assert p["stages"] >= 3
    # persistent: at most one CTA per SM, none without a row tile
    tiles = -(-rows // M.X_BM)
    assert 1 <= p["grid_x"] <= tiles
    assert p["grid_x"] * p["ncol"] <= max(132, p["ncol"])
    assert p["grid_x"] == tiles or (p["grid_x"] + 1) * p["ncol"] > 132
    assert p["loader_bytes"] == (16 if K % 4 == 0 else 4)
    assert M.gemm3x_plan(rows, K, N, aligned=False)["loader_bytes"] == 4
    assert p["split_bytes"] == 2 * 2 * kp * np_


@pytest.mark.parametrize("K,N,want", [
    (192, 192, dict(tile_n=192, ncol=1, resident=1, grid_x=132)),
    (192, 384, dict(tile_n=192, ncol=2, resident=1, grid_x=66)),
    (384, 192, dict(tile_n=192, ncol=1, resident=0, grid_x=132)),
], ids=["192-192", "192-384", "384-192"])
def test_gemm3x_plan_flagship(K, N, want):
    p = M.gemm3x_plan(13824, K, N)
    assert {k: p[k] for k in want} == want
    assert p["loader_bytes"] == 16


def test_gemm3x_plan_sms():
    """Fewer SMs: fewer CTAs per column tile, never none."""
    assert M.gemm3x_plan(13824, 1029, 2058, sms=4)["grid_x"] == 1
    assert M.gemm3x_plan(13824, 192, 192, sms=4)["grid_x"] == 4


@pytest.mark.parametrize("nin,nout", SHAPES)
def test_mm3x_chained_matches_ref_and_jax(jexp, nin, nout):
    a, m = _matrices(nin, nout, rows=130)
    y = M.mm3x_chained(a, m)
    assert y.dtype == np.float32
    yt = M.mm3x_ref(torch.as_tensor(a), torch.as_tensor(m)).numpy()
    yj = jexp._mm3x(jnp.asarray(a), jnp.asarray(m), jnp.float32)
    assert _rel(y, yt) <= 2e-6
    assert _rel(y, yj) <= 2e-6


def test_mm3x_chained_chain_length():
    """One chain over all of K is the unchained sum of the products."""
    a, m = _matrices(192, 192, rows=64)
    one = M.mm3x_chained(a, m, chain=192)
    ref = M.mm3x_ref(torch.as_tensor(a), torch.as_tensor(m)).numpy()
    assert _rel(one, ref) <= 2e-6
    assert _rel(M.mm3x_chained(a, m, chain=16), one) <= 2e-6


@pytest.mark.parametrize("nin,nout", SHAPES)
def test_gemm3x_cpu_is_ref(nin, nout):
    a, m = (torch.as_tensor(x) for x in _matrices(nin, nout, rows=65))
    before = M.gemm3x.launches
    u = M.gemm3x(a, m)
    assert M.gemm3x.launches == before == 0      # CPU: the plain version
    assert torch.equal(u, M.mm3x_ref(a, m))


def test_gemm3x_rejects():
    a, m = (torch.as_tensor(x) for x in _matrices(9, 18, rows=8))
    with pytest.raises(TypeError, match="float32"):
        M.gemm3x(a.double(), m.double())
    with pytest.raises(ValueError, match="contiguous"):
        M.gemm3x(a, m.t())
    with pytest.raises(ValueError, match="contiguous"):
        M.gemm3x(a[:, ::2], m[:5])
