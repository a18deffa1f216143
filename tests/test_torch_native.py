"""The port's native layer (pynama_tpu_torch/native, built with g++ here)
against the JAX package's: the mesh-graph helpers on the same meshes, the
numpy fallbacks against the native path, and the async binary writer."""
import logging
import os

import numpy as np
import numpy.testing as npt
import pytest

from pynama_tpu import native as jnative
from pynama_tpu.mesh import UnstructuredMesh
from pynama_tpu_torch import native as tnative
from pynama_tpu_torch.io.binary import BinarySnapshotWriter, load_snapshot
from pynama_tpu_torch.mesh.box import BoxMesh
from tests.msh_fixtures import grid_quad_mesh


@pytest.fixture
def no_native(monkeypatch):
    """The port's numpy fallbacks: PYNAMA_NO_NATIVE set, library unloaded."""
    monkeypatch.setenv("PYNAMA_NO_NATIVE", "1")
    monkeypatch.setattr(tnative, "_lib", None)


def _quad_mesh(ngl):
    v, q, lines = grid_quad_mesh(5, 4, distort=0.1)
    return UnstructuredMesh.create(ngl, v, q, lines)


def test_native_builds_into_build_dir():
    assert tnative.available()
    path = tnative._lib_path()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert os.path.exists(path) and path.endswith(".so")


def test_unique_edges_match():
    m = _quad_mesh(3)
    e_j, ce_j = jnative.unique_edges(m.cells_tensor)
    e_t, ce_t = tnative.unique_edges(m.cells_tensor)
    npt.assert_array_equal(e_t, e_j)
    npt.assert_array_equal(ce_t, ce_j)
    assert e_t.dtype == ce_t.dtype == np.int32


def test_unique_edges_fallback(no_native):
    m = _quad_mesh(3)
    e_j, ce_j = jnative.unique_edges(m.cells_tensor)
    e_t, ce_t = tnative.unique_edges(m.cells_tensor)
    npt.assert_array_equal(e_t, e_j)
    npt.assert_array_equal(ce_t, ce_j)


@pytest.mark.parametrize("ngl", [2, 3, 5])
def test_cell_nodes_match(ngl):
    """The port's native cell_nodes equals the JAX package's mesh table."""
    m = _quad_mesh(ngl)
    _, ce = jnative.unique_edges(m.cells_tensor)
    out = tnative.cell_nodes(m.cells_tensor, ce, m.n_vertices, m.n_edges,
                             ngl)
    npt.assert_array_equal(out, m.cell_nodes)


def test_cell_nodes_fallback_is_none(no_native):
    m = _quad_mesh(3)
    _, ce = tnative.unique_edges(m.cells_tensor)
    assert tnative.cell_nodes(m.cells_tensor, ce, m.n_vertices, m.n_edges,
                              3) is None


@pytest.mark.parametrize("native", [True, False])
def test_build_incidence_matches(monkeypatch, native):
    if not native:
        monkeypatch.setenv("PYNAMA_NO_NATIVE", "1")
        monkeypatch.setattr(tnative, "_lib", None)
    for mesh in (BoxMesh.create(4, (3, 3), (0, 0), (1, 1)),
                 BoxMesh.create(3, (2, 3, 2), (0, 0, 0), (1, 1, 1)),
                 _quad_mesh(4)):
        inc = tnative.build_incidence(mesh.cell_nodes, mesh.n_nodes)
        npt.assert_array_equal(
            inc, jnative.build_incidence(mesh.cell_nodes, mesh.n_nodes))


def test_writer_roundtrip_and_async(tmp_path):
    w = BinarySnapshotWriter(str(tmp_path))
    assert w.is_async
    rng = np.random.default_rng(0)
    a0 = rng.standard_normal((50, 2)).astype(np.float32)
    a1 = rng.standard_normal((50, 1))
    w.save(0, 0.0, velocity=a0, vorticity=a1)
    for s in range(1, 16):
        w.save(s, 0.01 * s, f=np.full((1000,), float(s)))
    w.close()
    assert not w.is_async
    npt.assert_array_equal(load_snapshot(str(tmp_path), 0, "velocity"), a0)
    npt.assert_array_equal(load_snapshot(str(tmp_path), 0, "vorticity"), a1)
    npt.assert_array_equal(load_snapshot(str(tmp_path), 7, "f"),
                           np.full((1000,), 7.0))
    with pytest.raises(KeyError):
        load_snapshot(str(tmp_path), 99, "f")


def test_writer_fallback_is_synchronous_and_logged(tmp_path, no_native,
                                                    caplog):
    caplog.set_level(logging.WARNING)
    w = BinarySnapshotWriter(str(tmp_path))
    assert not w.is_async
    assert any("synchronously" in r.getMessage() for r in caplog.records)
    w.save(2, 0.5, velocity=np.arange(6.0).reshape(3, 2))
    w.close()
    npt.assert_array_equal(load_snapshot(str(tmp_path), 2, "velocity"),
                           np.arange(6.0).reshape(3, 2))


def test_failed_build_falls_back(tmp_path, monkeypatch, caplog):
    """A build that fails is logged and leaves the numpy fallbacks."""
    caplog.set_level(logging.WARNING)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "FLAGS", tnative.FLAGS + ["-no-such-flag"])
    assert not tnative.available()
    assert any("native build failed" in r.getMessage()
               for r in caplog.records)
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
