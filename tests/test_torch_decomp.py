"""Port parity: pynama_tpu_torch.exp.fused_decomp (K3 variant_apply, K4
plainmm_apply and the decomposition driver) against the JAX package's
exp/fused_decomp.py.

The JAX kernels run in Pallas interpret mode: the loaded module's `pl` is
swapped (monkeypatch, nothing in exp/ changes) for a namespace whose
`pallas_call` passes interpret=True. On CPU tensors the port's wrappers run
their plain PyTorch versions, and their launch counters stay at 0. The CUDA
kernels need the card and are checked by chip_smoke.py. Tolerances:
1e-12 relative to max|ref| in float64 (only the summation order differs),
1e-5 in float32.
"""
import functools
import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from pynama_tpu_torch.exp import fused_decomp as D
from pynama_tpu_torch.mesh import BoxMesh
from pynama_tpu_torch.ops.fused import fused_apply_ref

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (nelem, ngl, ncomp_in, ncomp_out): 3D 3->3 and 3->6, 2D 9->18
CONFIGS = [((4, 3, 2), 3, 3, 3), ((4, 3, 2), 3, 3, 6), ((4, 3), 3, 1, 2)]
BLOCKS = [1, 2, 4]          # 1, 2 and ne0


def load_jax_exp(name):
    """exp/<name>.py loaded by path. Its import sets two JAX cache options
    and prepends "." to sys.path; all three are restored."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_exp_{name}", os.path.join(REPO, "exp", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


def interpret_pl():
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                  if not k.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return ns


@pytest.fixture(scope="module")
def jexp():
    return load_jax_exp("fused_decomp")


@pytest.fixture
def jx(jexp, monkeypatch):
    monkeypatch.setattr(jexp, "pl", interpret_pl())
    return jexp


def _inputs(nelem, ngl, cin, cout, seed=3):
    nn = ngl ** len(nelem)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((int(np.prod(nelem)), nn * cin)),
            rng.standard_normal((nn * cin, nn * cout)))


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max()) / float(np.abs(b).max())


def _dup_consistent(y, nelem, ngl, cout):
    """Every slot of one global node holds the same bits."""
    dim = len(nelem)
    cn = BoxMesh.create(ngl, nelem, [0] * dim, [1] * dim).cell_nodes.ravel()
    gid = torch.as_tensor(np.repeat(cn, cout) * cout
                          + np.tile(np.arange(cout), cn.size))
    n = int(cn.max()) * cout + cout
    flat = y.reshape(-1)
    hi = torch.full((n,), -np.inf, dtype=y.dtype).scatter_reduce(
        0, gid, flat, "amax")
    lo = torch.full((n,), np.inf, dtype=y.dtype).scatter_reduce(
        0, gid, flat, "amin")
    return torch.equal(hi, lo)


@pytest.mark.parametrize("do_rolls", [True, False])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("nelem,ngl,cin,cout", CONFIGS)
def test_variant_matches_jax(jx, nelem, ngl, cin, cout, block, do_rolls):
    t, m = _inputs(nelem, ngl, cin, cout)
    yj = jx.variant_apply(jnp.asarray(t), jnp.asarray(m), tuple(nelem), ngl,
                          cout, block=block, do_rolls=do_rolls)
    yt = D.variant_apply(torch.as_tensor(t), torch.as_tensor(m), nelem, ngl,
                         cout, block, do_rolls=do_rolls)
    assert D.variant_apply.launches == 0        # CPU: the plain version
    assert yt.shape == yj.shape
    assert _rel(yt.numpy(), yj) <= 1e-12


@pytest.mark.parametrize("do_rolls", [True, False])
def test_variant_matches_jax_f32(jx, do_rolls):
    nelem, ngl, cin, cout = CONFIGS[0]
    t, m = (a.astype(np.float32) for a in _inputs(nelem, ngl, cin, cout))
    yj = jx.variant_apply(jnp.asarray(t), jnp.asarray(m), nelem, ngl, cout,
                          block=2, do_rolls=do_rolls)
    yt = D.variant_apply(torch.as_tensor(t), torch.as_tensor(m), nelem, ngl,
                         cout, 2, do_rolls=do_rolls)
    assert yt.dtype == torch.float32 and _rel(yt.numpy(), yj) <= 1e-5


@pytest.mark.parametrize("nelem,ngl,cin,cout", CONFIGS)
def test_variant_with_rolls_is_fused_apply(nelem, ngl, cin, cout):
    """do_rolls=True: K1's y, bitwise, with every duplicate slot equal."""
    t, m = (torch.as_tensor(a) for a in _inputs(nelem, ngl, cin, cout, 5))
    y = D.variant_apply(t, m, nelem, ngl, cout, 2)
    assert torch.equal(y, fused_apply_ref(t, m, nelem, ngl, cout)[0])
    assert _dup_consistent(y, nelem, ngl, cout)


# 3D 3->6, and 2D planes of 3 * ncomp values (6, 9) and 4 * 3 (12)
SEAM_2D = [((4, 3), 3, 1, 2), ((4, 5), 3, 2, 3), ((4, 2), 4, 3, 3)]
SEAM_CASES = (
    [pytest.param(CONFIGS[1], b, id=str(b)) for b in BLOCKS]
    + [pytest.param(c, b, id=f"2d-{c[0][0]}x{c[0][1]}-ngl{c[1]}-{c[2]}to"
                    f"{c[3]}-{b}") for c in SEAM_2D for b in BLOCKS])


@pytest.mark.parametrize("config,block", SEAM_CASES)
def test_variant_seams_only(config, block):
    """do_rolls=False: u = t @ m except at the interior block seams, where
    both slots of each pair hold the same bits, u[lo] + u[hi]."""
    nelem, ngl, cin, cout = config
    t, m = _inputs(nelem, ngl, cin, cout, 9)
    y = D.variant_apply(torch.as_tensor(t), torch.as_tensor(m), nelem, ngl,
                        cout, block, do_rolls=False).numpy()
    ne0, R = nelem[0], int(np.prod(nelem[1:]))
    dim = len(nelem)
    nnc, plane = ngl ** dim * cout, ngl ** (dim - 1) * cout
    want = (t @ m).reshape(ne0, R, nnc)
    for s in range(1, ne0 // block):
        lo, hi = s * block - 1, s * block
        v = want[lo, :, nnc - plane:] + want[hi, :, :plane]
        want[lo, :, nnc - plane:] = v
        want[hi, :, :plane] = v
    y3 = y.reshape(ne0, R, nnc)
    np.testing.assert_array_equal(y3[block - 1:ne0 - 1:block, :, nnc - plane:],
                                  y3[block::block, :, :plane])
    assert _rel(y, want.reshape(y.shape)) <= 1e-12
    if block == ne0:                            # no seams: y is u, bitwise
        np.testing.assert_array_equal(
            y, (torch.as_tensor(t) @ torch.as_tensor(m)).numpy())


@pytest.mark.parametrize("E,nin,nout,block", [(24, 27, 27, 6),
                                              (12, 9, 18, 12)])
def test_plainmm_matches_jax(jx, E, nin, nout, block):
    rng = np.random.default_rng(E)
    t = rng.standard_normal((E, nin))
    m = rng.standard_normal((nin, nout))
    yj = jx.plainmm_apply(jnp.asarray(t), jnp.asarray(m), block=block)
    yt = D.plainmm_apply(torch.as_tensor(t), torch.as_tensor(m), block)
    assert D.plainmm_apply.launches == 0
    assert yt.shape == yj.shape and _rel(yt.numpy(), yj) <= 1e-12


@pytest.mark.parametrize("fn", [
    lambda t, m: D.variant_apply(t, m, (4, 3, 2), 3, 3, 3),
    lambda t, m: D.variant_apply_ref(t, m, (4, 3, 2), 3, 3, 3, False),
    lambda t, m: D.plainmm_apply(t, m, 5),
    lambda t, m: D.plainmm_apply_ref(t, m, 0),
], ids=["variant", "variant_ref", "plainmm", "plainmm_ref"])
def test_block_must_divide(fn):
    t, m = (torch.as_tensor(a) for a in _inputs((4, 3, 2), 3, 3, 3))
    with pytest.raises(ValueError, match="does not divide"):
        fn(t, m)


def test_plainmm_rejects_bad_inputs():
    t, m = (torch.as_tensor(a) for a in _inputs((4, 3), 3, 1, 2))
    with pytest.raises(TypeError):
        D.plainmm_apply(t.float(), m, 12)                   # mixed dtypes
    with pytest.raises(ValueError, match="multiply"):
        D.plainmm_apply(t, m[:-1].contiguous(), 12)
    with pytest.raises(ValueError, match="contiguous"):
        D.plainmm_apply(t, torch.cat([m, m], dim=1)[:, ::2], 12)
    with pytest.raises(ValueError, match="cpu or cuda"):
        D.plainmm_apply(t.to("meta"), m.to("meta"), 12)


def test_fused_decomp_driver_runs(capsys):
    best = D.main(["3", "3", "--nit", "4", "--rounds", "1", "--device",
                   "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("device: cpu;")
    for line in ("=== decomposition", "dss pass (fused-nodss)",
                 "seam adds (nodss-plainmm)", "hand-vs-cublas mm",
                 "fused win vs torch"):
        assert line in out
    assert set(best) == {"fused", "nodss", "plainmm", "torch_mm",
                         "torch_full"}
    assert all(np.isfinite(v) and v > 0 for v in best.values())
    assert D.variant_apply.launches == D.plainmm_apply.launches == 0


def test_driver_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        D.main(["3", "3"])                      # default --device cuda
