"""Port parity: pynama_tpu_torch.ops.apply (the global-layout ElementOp
path) against pynama_tpu.ops.apply, float64 on the CPU.

The same numpy-seeded operators and fields go through both packages:
apply_op (shared and per-element matrices), element_gather, fanin_sum and
assembled_diagonal to 1e-12 relative; the numpy twins (fanin_sum_np,
assembled_diagonal_np, assemble_dense) carried over unchanged, so equal.
The matrix-free apply must equal the dense assembled matvec, and the
device diagonal the dense diagonal (tests/test_mesh.py's PETSc-parity
check).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.mesh import BoxMesh as JBox
from pynama_tpu.ops import apply as J
from pynama_tpu_torch.mesh import BoxMesh as TBox
from pynama_tpu_torch.ops import apply as T

torch.set_num_threads(1)

F64 = torch.float64
# (ngl, nelem, din, dout): K v->v, Rw w->v, curl v->w, srt v->s, div s->v
CASES = [(3, (3, 4), 2, 2), (3, (3, 4), 1, 2), (4, (2, 3), 2, 3),
         (3, (2, 2, 2), 3, 3), (3, (2, 2, 2), 3, 6), (3, (2, 1, 2), 6, 3)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


def _ops(ngl, nelem, din, dout, per_element, seed=0):
    """(numpy matrix, JAX ElementOp, port ElementOp, mesh, rng)."""
    dim = len(nelem)
    mesh = TBox.create(ngl, nelem, [0] * dim, [1] * dim)
    jm = JBox.create(ngl, nelem, [0] * dim, [1] * dim)
    np.testing.assert_array_equal(mesh.incidence, np.asarray(jm.incidence))
    rng = np.random.default_rng(seed)
    nn = mesh.nnode_el
    shape = (nn * dout, nn * din)
    mat = rng.standard_normal(((mesh.n_cells,) + shape) if per_element
                              else shape)
    jop = J.make_element_op(mat, mesh.cell_nodes, jm.incidence, din, dout,
                            mesh.n_nodes)
    top = T.make_element_op(mat, mesh.cell_nodes, mesh.incidence, din, dout,
                            mesh.n_nodes, device="cpu", dtype=F64)
    return mat, jop, top, mesh, rng


@pytest.mark.parametrize("per_element", [False, True])
@pytest.mark.parametrize("ngl,nelem,din,dout", CASES)
def test_apply_op_matches(ngl, nelem, din, dout, per_element):
    mat, jop, top, mesh, rng = _ops(ngl, nelem, din, dout, per_element)
    assert top.cell_nodes.dtype == top.incidence.dtype == torch.int64
    assert (top.n_cells, top.nnode_el) == (jop.n_cells, jop.nnode_el)
    x = rng.standard_normal((mesh.n_nodes, din))
    xt = torch.as_tensor(x)
    assert _rel(T.element_gather(top, xt).numpy(),
                J.element_gather(jop, jnp.asarray(x))) == 0.0
    y = T.apply_op(top, xt).numpy()
    assert y.shape == (mesh.n_nodes, dout)
    assert _rel(y, J.apply_op(jop, jnp.asarray(x))) <= 1e-12
    A = T.assemble_dense(mat, mesh.cell_nodes, din, dout, mesh.n_nodes)
    assert _rel(y.ravel(), A @ x.ravel()) <= 1e-12
    ze = rng.standard_normal((mesh.n_cells, mesh.nnode_el * dout))
    got = T.fanin_sum(top, torch.as_tensor(ze)).numpy()
    assert _rel(got, J.fanin_sum(jop, jnp.asarray(ze))) <= 1e-12
    assert _rel(got, T.fanin_sum_np(mesh.cell_nodes, ze, dout,
                                    mesh.n_nodes)) <= 1e-12


@pytest.mark.parametrize("per_element", [False, True])
@pytest.mark.parametrize("ngl,nelem,din,dout",
                         [c for c in CASES if c[2] == c[3]])
def test_assembled_diagonal_matches(ngl, nelem, din, dout, per_element):
    mat, jop, top, mesh, _ = _ops(ngl, nelem, din, dout, per_element, 1)
    d = T.assembled_diagonal(top).numpy()
    assert _rel(d, J.assembled_diagonal(jop)) <= 1e-12
    np.testing.assert_array_equal(
        T.assembled_diagonal_np(mat, mesh.cell_nodes, mesh.n_nodes),
        J.assembled_diagonal_np(mat, mesh.cell_nodes, mesh.n_nodes))
    A = T.assemble_dense(mat, mesh.cell_nodes, din, dout, mesh.n_nodes)
    np.testing.assert_array_equal(
        A, J.assemble_dense(mat, mesh.cell_nodes, din, dout, mesh.n_nodes))
    assert _rel(d.ravel(), np.diagonal(A)) <= 1e-12


def test_assembled_diagonal_needs_square():
    _, _, top, _, _ = _ops(3, (2, 2), 1, 2, False)
    with pytest.raises(ValueError, match="square"):
        T.assembled_diagonal(top)


def test_fanin_sum_np_matches():
    rng = np.random.default_rng(2)
    mesh = TBox.create(3, (3, 2), [0, 0], [1, 1])
    ze = rng.standard_normal((mesh.n_cells, mesh.nnode_el * 3))
    np.testing.assert_array_equal(
        T.fanin_sum_np(mesh.cell_nodes, ze, 3, mesh.n_nodes),
        J.fanin_sum_np(mesh.cell_nodes, ze, 3, mesh.n_nodes))


def test_make_element_op_shares_index_tensors():
    """Tensors already int64 on the device are shared, not copied: one
    cell_nodes/incidence pair serves every operator of a Problem."""
    mesh = TBox.create(3, (2, 2), [0, 0], [1, 1])
    cn = torch.as_tensor(mesh.cell_nodes.astype(np.int64))
    inc = torch.as_tensor(mesh.incidence.astype(np.int64))
    m = np.eye(mesh.nnode_el * 2)
    a = T.make_element_op(m, cn, inc, 2, 2, mesh.n_nodes, device="cpu",
                          dtype=torch.float32)
    assert a.cell_nodes is cn and a.incidence is inc
    assert a.mat.dtype == torch.float32
