"""Port parity: pynama_tpu_torch.ops.fused against the JAX Pallas kernel.

On a CPU tensor the port's `fused_apply` runs its plain PyTorch version;
the JAX `fused_apply` runs in Pallas interpret mode, as tests/test_fused.py
runs it. Both `y` and the raw boundary planes `bnd` must agree to 1e-12
relative in float64. The CUDA kernel itself needs the GPU and is checked
by chip_smoke.py (kernel against this plain version, on the card).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynama_tpu.ops.fused import fused_apply as jax_fused_apply
from pynama_tpu_torch.mesh import BoxMesh
from pynama_tpu_torch.ops.fused import fused_apply, fused_apply_ref

torch.set_num_threads(1)

CONFIGS = [
    ((3, 4, 5), 4, 3, 3),
    ((3, 4, 5), 4, 3, 6),     # strain-family output (ncomp_out != in)
    ((2, 3), 5, 2, 3),        # 2D
    ((2, 3), 3, 2, 1),        # 2D scalar vorticity
    ((1, 2, 2), 3, 3, 1),     # degenerate axis-0 extent
    ((4, 1, 2), 4, 3, 3),     # degenerate in-slice extent
    ((2, 2, 2), 2, 3, 3),     # ngl=2 (planes cover every column)
    ((3, 4), 3, 1, 2),        # 2D ngl=3 9->18 (vorticity -> velocity, Rw)
]


def _inputs(nelem, ngl, cin, cout, seed=7):
    dim = len(nelem)
    nn = ngl ** dim
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((int(np.prod(nelem)), nn * cin))
    matT = rng.standard_normal((nn * cin, nn * cout))
    return t, matT


@pytest.mark.parametrize("nelem,ngl,cin,cout", CONFIGS)
def test_fused_matches_jax_kernel(nelem, ngl, cin, cout):
    t, matT = _inputs(nelem, ngl, cin, cout)
    yj, bj = jax_fused_apply(jnp.asarray(t), jnp.asarray(matT),
                             tuple(nelem), ngl, cout, interpret=True)
    launches = fused_apply.launches
    yt, bt = fused_apply(torch.as_tensor(t), torch.as_tensor(matT),
                         nelem, ngl, cout)
    assert fused_apply.launches == launches    # CPU: the plain version
    scale = float(np.abs(np.asarray(yj)).max())
    assert yt.shape == yj.shape and bt.shape == bj.shape
    assert float(np.abs(yt.numpy() - np.asarray(yj)).max()) / scale <= 1e-12
    assert float(np.abs(bt.numpy() - np.asarray(bj)).max()) / scale <= 1e-12


@pytest.mark.parametrize("nelem,ngl,cin,cout", CONFIGS)
def test_duplicate_slots_bitwise_equal(nelem, ngl, cin, cout):
    """Every slot of one global node holds the same bits (the consistent-
    fields contract the engine's weighted dots and to_global rely on)."""
    t, matT = _inputs(nelem, ngl, cin, cout, seed=11)
    y, _ = fused_apply(torch.as_tensor(t), torch.as_tensor(matT),
                       nelem, ngl, cout)
    dim = len(nelem)
    mesh = BoxMesh.create(ngl, nelem, [0] * dim, [1] * dim)
    cn = mesh.cell_nodes.ravel()
    gid = torch.as_tensor(np.repeat(cn, cout) * cout
                          + np.tile(np.arange(cout), cn.size))
    n = mesh.n_nodes * cout
    flat = y.reshape(-1)
    hi = torch.full((n,), -np.inf, dtype=y.dtype).scatter_reduce(
        0, gid, flat, "amax")
    lo = torch.full((n,), np.inf, dtype=y.dtype).scatter_reduce(
        0, gid, flat, "amin")
    assert torch.equal(hi, lo)


def test_wrapper_rejects_bad_inputs():
    t, matT = _inputs((2, 3), 3, 2, 1)
    t32 = torch.as_tensor(t)
    m = torch.as_tensor(matT)
    with pytest.raises(TypeError):
        fused_apply(t32.to(torch.float16), m.to(torch.float16), (2, 3), 3, 1)
    with pytest.raises(TypeError):
        fused_apply(t32.float(), m, (2, 3), 3, 1)          # mixed dtypes
    with pytest.raises(TypeError):
        fused_apply(t32.long(), m.long(), (2, 3), 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.as_tensor(np.concatenate([t, t], axis=1))
        fused_apply(wide[:, ::2], m, (2, 3), 3, 1)
    with pytest.raises(ValueError):
        fused_apply(t32[:-1].contiguous(), m, (2, 3), 3, 1)  # wrong E
    with pytest.raises(ValueError):
        fused_apply(t32, m[:, :-1].contiguous(), (2, 3), 3, 1)
    with pytest.raises(ValueError):
        fused_apply(t32, m, (2, 3), 1, 1)                    # ngl < 2
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_apply(t32.to("meta"), m.to("meta"), (2, 3), 3, 1)


def test_reference_is_dss_of_emm():
    """fused_apply_ref is dss(emm(t, matT)) by construction: check it
    against a direct scatter-add assembly through global node ids."""
    nelem, ngl, cin, cout = (3, 2, 2), 3, 3, 3
    t, matT = _inputs(nelem, ngl, cin, cout, seed=2)
    y, _ = fused_apply_ref(torch.as_tensor(t), torch.as_tensor(matT),
                           nelem, ngl, cout)
    mesh = BoxMesh.create(ngl, nelem, [0] * 3, [1] * 3)
    z = t @ matT
    cn = mesh.cell_nodes.ravel()
    gid = np.repeat(cn, cout) * cout + np.tile(np.arange(cout), cn.size)
    acc = np.zeros(mesh.n_nodes * cout)
    np.add.at(acc, gid, z.ravel())
    want = acc[gid].reshape(z.shape)
    assert float(np.abs(y.numpy() - want).max()) <= 1e-12 * float(
        np.abs(want).max())
