"""Port parity: pynama_tpu_torch.ops.local against pynama_tpu.ops.local.

`emm`, `dss` and `local_dot` on the box-mesh configurations of
tests/test_fused.py, float64 on the CPU, relative error <= 1e-12 (the two
packages sum in different orders only inside the matmul).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynama_tpu.mesh import BoxMesh
from pynama_tpu.ops import local as JL
from pynama_tpu_torch.ops import local as TL

torch.set_num_threads(1)

CONFIGS = [
    ((3, 4, 5), 4, 3, 3),
    ((3, 4, 5), 4, 3, 6),
    ((2, 3), 5, 2, 3),
    ((2, 3), 3, 2, 1),
    ((1, 2, 2), 3, 3, 1),
    ((4, 1, 2), 4, 3, 3),
    ((2, 2, 2), 2, 3, 3),
]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-300)


def _setup(nelem, ngl, cin, cout, seed=7):
    dim = len(nelem)
    mesh = BoxMesh.create(ngl, list(nelem), [0] * dim, [1] * dim)
    nn = ngl ** dim
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((mesh.n_cells, nn * cin))
    matT = rng.standard_normal((nn * cin, nn * cout))
    return mesh, t, matT


@pytest.mark.parametrize("nelem,ngl,cin,cout", CONFIGS)
def test_emm_and_dss_match(nelem, ngl, cin, cout):
    mesh, t, matT = _setup(nelem, ngl, cin, cout)
    jlay = JL.make_local_layout(mesh, cout, dtype=jnp.float64)
    tlay = TL.make_local_layout(mesh, cout, device="cpu",
                                dtype=torch.float64)
    np.testing.assert_array_equal(tlay.inv_mult.numpy(),
                                  np.asarray(jlay.inv_mult))
    for pj, pt in zip(jlay.perms, tlay.perms):
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))

    zj = JL.emm(jnp.asarray(t), jnp.asarray(matT))
    zt = TL.emm(torch.as_tensor(t), torch.as_tensor(matT))
    assert _rel(zt.numpy(), zj) <= 1e-12
    # DSS on identical input: the same adds in the same order
    yj = JL.dss(jlay, zj)
    yt = TL.dss(tlay, torch.as_tensor(np.array(zj)))
    assert _rel(yt.numpy(), yj) <= 1e-12


@pytest.mark.parametrize("nelem,ngl,cin,cout", CONFIGS)
def test_local_dot_matches(nelem, ngl, cin, cout):
    mesh, _, _ = _setup(nelem, ngl, cin, cout)
    rng = np.random.default_rng(3)
    a = JL.to_local(mesh, rng.standard_normal((mesh.n_nodes, cout)))
    b = JL.to_local(mesh, rng.standard_normal((mesh.n_nodes, cout)))
    jlay = JL.make_local_layout(mesh, cout, dtype=jnp.float64)
    tlay = TL.make_local_layout(mesh, cout, device="cpu",
                                dtype=torch.float64)
    want = float(JL.local_dot(jlay, jnp.asarray(a), jnp.asarray(b)))
    got = float(TL.local_dot(tlay, torch.as_tensor(a), torch.as_tensor(b)))
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("nelem,ngl,cin,cout", CONFIGS[:3])
def test_global_local_shuttles_and_dss_np_match(nelem, ngl, cin, cout):
    mesh, t, _ = _setup(nelem, ngl, cin, cout)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((mesh.n_nodes, cout))
    np.testing.assert_array_equal(TL.to_local(mesh, x), JL.to_local(mesh, x))
    tl = JL.to_local(mesh, x)
    np.testing.assert_array_equal(TL.to_global(mesh, tl, cout),
                                  JL.to_global(mesh, tl, cout))
    z = rng.standard_normal((mesh.n_cells, mesh.nnode_el * cout))
    np.testing.assert_array_equal(TL.dss_np(mesh, z, cout),
                                  JL.dss_np(mesh, z, cout))
