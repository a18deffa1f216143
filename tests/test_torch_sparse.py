"""Port parity: pynama_tpu_torch.sparse against pynama_tpu.sparse, float64
on the CPU.

Every format's assembly from element matrices (COO, CSR, ELL, BSR) gives
the JAX package's index arrays exactly and its values to 1e-14, and every
SpMV/SpMM matches the JAX package and the dense assembled matrix to 1e-12;
SpGEMM (numpy, carried over) matches JAX's and the dense product
(tests/test_sparse_extra.py's cases, through the port).
"""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from pynama_tpu import sparse as JS
from pynama_tpu.mesh import BoxMesh as JBox
from pynama_tpu.sparse.assemble import coo_to_csr as j_coo_to_csr
from pynama_tpu_torch import sparse as TS
from pynama_tpu_torch.ops.apply import assemble_dense
from pynama_tpu_torch.sparse.assemble import coo_to_csr

torch.set_num_threads(1)

FORMATS = ["coo", "csr", "ell", "bsr"]
FIELDS = {"coo": ("data", "row", "col"), "csr": ("data", "indices",
                                                 "indptr"),
          "ell": ("data", "cols"), "bsr": ("data", "indices", "indptr")}


def _element_case(dim, seed=0):
    ngl, nelem, din = 3, (3, 2, 2)[:dim], dim
    mesh = JBox.create(ngl, nelem, [0] * dim, [1] * dim)
    rng = np.random.default_rng(seed)
    nd = mesh.nnode_el * din
    mats = rng.standard_normal((mesh.n_cells, nd, nd))
    cn = np.asarray(mesh.cell_nodes)
    return mats, cn, din, mesh.n_nodes, rng


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dim", [2, 3])
def test_assembly_matches(dim, fmt):
    mats, cn, din, n, rng = _element_case(dim)
    a = TS.assemble_from_elements(mats, cn, din, din, n, fmt=fmt,
                                  device="cpu")
    b = JS.assemble_from_elements(mats, cn, din, din, n, fmt=fmt)
    assert a.shape == b.shape
    for f in FIELDS[fmt]:
        got, want = getattr(a, f).numpy(), np.asarray(getattr(b, f))
        assert got.shape == want.shape, f
        if f == "data":
            npt.assert_allclose(got, want, rtol=0, atol=1e-14 * np.abs(
                want).max())
        else:
            assert getattr(a, f).dtype == torch.int64
            npt.assert_array_equal(got, want)


# one vector, and three (SpMM); BSR takes one vector, as in the JAX package
@pytest.mark.parametrize("fmt,ncol", [(f, c) for f in FORMATS
                                      for c in (None, 3)
                                      if not (f == "bsr" and c)])
@pytest.mark.parametrize("dim", [2, 3])
def test_spmv_matches(dim, fmt, ncol):
    mats, cn, din, n, rng = _element_case(dim, 1)
    dense = assemble_dense(mats, cn, din, din, n)
    x = rng.standard_normal((n * din,) if ncol is None else (n * din, ncol))
    a = TS.assemble_from_elements(mats, cn, din, din, n, fmt=fmt,
                                  device="cpu")
    b = JS.assemble_from_elements(mats, cn, din, din, n, fmt=fmt)
    y = TS.spmv(a, torch.as_tensor(x)).numpy()
    scale = np.abs(dense @ x).max()
    assert np.abs(y - dense @ x).max() <= 1e-12 * scale
    assert np.abs(y - np.asarray(JS.spmv(b, jnp.asarray(x)))).max() \
        <= 1e-12 * scale


def test_spmv_rejects_unknown_type():
    with pytest.raises(TypeError):
        TS.spmv(np.eye(3), torch.zeros(3))


def test_ell_padding_and_dtype():
    """pad_to rounds the width up, padding points at the zero column;
    dtype casts the values (float32 ELL, float32 SpMV)."""
    mats, cn, din, n, rng = _element_case(2, 2)
    a = TS.assemble_from_elements(mats, cn, din, din, n, fmt="ell",
                                  dtype=torch.float32, pad_to=16,
                                  device="cpu")
    assert a.width % 16 == 0 and a.data.dtype == torch.float32
    assert int(a.cols.max()) == a.shape[1]
    x = rng.standard_normal(n * din)
    y = TS.spmv_ell(a, torch.as_tensor(x, dtype=torch.float32)).numpy()
    want = assemble_dense(mats, cn, din, din, n) @ x
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()


def rand_sparse(rng, n, m, density=0.15):
    """(dense, port COO, JAX COO) of one random sparse matrix."""
    mask = rng.random((n, m)) < density
    dense = np.where(mask, rng.standard_normal((n, m)), 0.0)
    r, c = np.nonzero(dense)
    t = TS.COO(data=torch.as_tensor(dense[r, c]), row=torch.as_tensor(r),
               col=torch.as_tensor(c), shape=(n, m))
    j = JS.COO(data=jnp.asarray(dense[r, c]),
               row=jnp.asarray(r.astype(np.int32)),
               col=jnp.asarray(c.astype(np.int32)), shape=(n, m))
    return dense, t, j


def _dense_of(C):
    ip, ix, d = C.indptr.numpy(), C.indices.numpy(), C.data.numpy()
    out = np.zeros(C.shape)
    for i in range(C.shape[0]):
        for k in range(ip[i], ip[i + 1]):
            out[i, ix[k]] = d[k]
    return out


def test_spmm_multivector():
    rng = np.random.default_rng(0)
    dense, A, Aj = rand_sparse(rng, 30, 20)
    X = rng.standard_normal((20, 5))
    for M, Mj in ((coo_to_csr(A), j_coo_to_csr(Aj)), (A, Aj)):
        got = TS.spmv(M, torch.as_tensor(X)).numpy()
        npt.assert_allclose(got, dense @ X, rtol=1e-12, atol=1e-12)
        npt.assert_allclose(got, np.asarray(JS.spmv(Mj, jnp.asarray(X))),
                            rtol=1e-12, atol=1e-12)


def test_spgemm_matches_dense():
    rng = np.random.default_rng(1)
    dA, A, Aj = rand_sparse(rng, 25, 40)
    dB, B, Bj = rand_sparse(rng, 40, 18)
    C = TS.spgemm(coo_to_csr(A), coo_to_csr(B))
    npt.assert_allclose(_dense_of(C), dA @ dB, rtol=1e-12, atol=1e-12)
    Cj = JS.spgemm(j_coo_to_csr(Aj), j_coo_to_csr(Bj))
    npt.assert_array_equal(C.indptr.numpy(), np.asarray(Cj.indptr))
    npt.assert_array_equal(C.indices.numpy(), np.asarray(Cj.indices))
    npt.assert_allclose(C.data.numpy(), np.asarray(Cj.data), rtol=1e-14,
                        atol=0)


def test_spgemm_coo_inputs_and_duplicates():
    rng = np.random.default_rng(2)
    dA, A, _ = rand_sparse(rng, 12, 12, density=0.4)
    C = TS.spgemm(A, A)
    npt.assert_allclose(_dense_of(C), dA @ dA, rtol=1e-12, atol=1e-12)
    ip, ix = C.indptr.numpy(), C.indices.numpy()
    for i in range(12):
        assert (np.diff(ix[ip[i]:ip[i + 1]]) > 0).all()
    with pytest.raises(ValueError, match="shape mismatch"):
        TS.spgemm(A, rand_sparse(rng, 5, 4)[1])
