"""Port parity: pynama_tpu_torch.mesh.gmsh against pynama_tpu.mesh.gmsh.

The same generated .msh fixtures (tests/msh_fixtures.py: MSH 2.2 and 4.1
quads, MSH 2.2 hexes; interior vertices distorted from a numpy seed) go
through both readers; every table of the result is equal exactly, and the
reader's errors are the reference's. `mesh_from_gmsh` picks the mesh type
by the file's contents.
"""
import numpy as np
import pytest
import torch

from pynama_tpu.mesh import gmsh as JG
from pynama_tpu_torch.mesh import HexMesh, UnstructuredMesh, mesh_from_gmsh
from pynama_tpu_torch.mesh import gmsh as TG
from tests.msh_fixtures import (grid_hex_mesh, grid_quad_mesh, write_msh22,
                                write_msh22_3d, write_msh41)

torch.set_num_threads(1)

QUAD_WRITERS = {"msh22": write_msh22, "msh41": write_msh41}


def _write(tmp_path, kind, n, distort, seed):
    path = str(tmp_path / f"{kind}.msh")
    if kind == "hex":
        v, cells, groups = grid_hex_mesh(*n, distort=distort, seed=seed)
        write_msh22_3d(path, v, cells, groups)
    else:
        v, cells, groups = grid_quad_mesh(*n, distort=distort, seed=seed)
        QUAD_WRITERS[kind](path, v, cells, groups)
    return path, v, cells, groups


def _same_groups(a: dict, b: dict):
    assert list(a) == list(b)
    for name in a:
        assert a[name].dtype == b[name].dtype
        np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("kind,n", [
    ("msh22", (3, 2)), ("msh41", (3, 2)), ("msh22", (5, 4)),
    ("msh41", (4, 6)), ("hex", (2, 2, 2)), ("hex", (3, 2, 1)),
])
def test_read_msh_matches(tmp_path, kind, n):
    path, v, cells, groups = _write(tmp_path, kind, n, 0.15, seed=3)
    got, want = TG.read_msh(path), JG.read_msh(path)
    assert bool(got.is_3d) == bool(want.is_3d) == (kind == "hex")
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_allclose(got.vertices, v, atol=1e-14)
    np.testing.assert_array_equal(got.quads, want.quads)
    assert got.quads.dtype == want.quads.dtype
    _same_groups(got.lines, want.lines)
    if kind == "hex":
        np.testing.assert_array_equal(got.hexes, want.hexes)
        np.testing.assert_array_equal(got.hexes, cells)
        _same_groups(got.surfaces, want.surfaces)
        assert set(got.surfaces) == set(groups)
    else:
        assert got.hexes is want.hexes is None
        np.testing.assert_array_equal(got.quads, cells)
        assert set(got.lines) == set(groups)


@pytest.mark.parametrize("kind,n,cls", [
    ("msh22", (3, 3), UnstructuredMesh), ("msh41", (2, 3), UnstructuredMesh),
    ("hex", (2, 1, 2), HexMesh),
])
def test_mesh_from_gmsh_dispatches(tmp_path, kind, n, cls):
    path, _, cells, _ = _write(tmp_path, kind, n, 0.1, seed=0)
    m = mesh_from_gmsh(path, 3)
    assert type(m) is cls
    assert m.n_cells == len(cells) and m.ngl == 3
    if cls is UnstructuredMesh:
        assert UnstructuredMesh.from_gmsh(path, 3).n_nodes == m.n_nodes
    else:
        with pytest.raises(ValueError, match="hex volumes"):
            UnstructuredMesh.from_gmsh(path, 3)


@pytest.mark.parametrize("text,match", [
    ("hello\n", "not a gmsh file"),
    ("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n2\n1 0 0 0\n2 1 0 0\n"
     "$EndNodes\n$Elements\n1\n1 1 2 1 1 1 2\n$EndElements\n",
     "no quad"),
    ("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n4\n1 0 0 0\n2 1 0 0\n"
     "3 1 1 1\n4 0 1 0\n$EndNodes\n$Elements\n1\n1 3 2 1 1 1 2 3 4\n"
     "$EndElements\n", "not planar"),
])
def test_read_msh_errors_match(tmp_path, text, match):
    path = tmp_path / "bad.msh"
    path.write_text(text)
    for reader in (TG.read_msh, JG.read_msh):
        with pytest.raises(ValueError, match=match):
            reader(str(path))
