"""Port parity: the host-side setup of pynama_tpu_torch equals pynama_tpu's.

Basis tables, the box mesh, the element matrices/operators and the boundary
masks are numpy in both packages and must agree exactly (float64 build;
tolerance 0, or 1e-14 relative where the arithmetic runs through BLAS).
"""
import dataclasses
import shutil
import subprocess
import sys
import os

import numpy as np
import pytest
import torch

from pynama_tpu import basis as jb
from pynama_tpu import elements as je
from pynama_tpu.bc import BoundaryConditions as JBC
from pynama_tpu.mesh import BoxMesh as JBox

from pynama_tpu_torch import basis as tb
from pynama_tpu_torch import elements as te
from pynama_tpu_torch.bc import BoundaryConditions as TBC
from pynama_tpu_torch.mesh import BoxMesh as TBox

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = [(3, (6, 6)), (3, (2, 2, 2))]      # (ngl, nelem)


def _eq(a, b, tol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-300)
    assert float(np.abs(a - b).max(initial=0.0)) <= tol * scale


@pytest.mark.parametrize("ngl,nelem", MESHES)
def test_basis_matches(ngl, nelem):
    dim = len(nelem)
    a = tb.make_tensor_basis(ngl, dim)
    b = jb.make_tensor_basis(ngl, dim)
    _eq(a.nodes1d, b.nodes1d)
    _eq(a.weights1d, b.weights1d)
    for fam in ("full", "reduced", "operator"):
        fa, fb = getattr(a, fam), getattr(b, fam)
        for f in dataclasses.fields(fa):
            _eq(getattr(fa, f.name), getattr(fb, f.name))


@pytest.mark.parametrize("ngl,nelem", MESHES)
def test_box_mesh_matches(ngl, nelem):
    dim = len(nelem)
    a = TBox.create(ngl, nelem, [0] * dim, [1] * dim)
    b = JBox.create(ngl, nelem, [0] * dim, [1] * dim)
    _eq(a.coords, b.coords)
    np.testing.assert_array_equal(a.cell_nodes, b.cell_nodes)
    _eq(a.cell_corners, b.cell_corners)
    for side in b.border_name_list:
        np.testing.assert_array_equal(a.border_nodes(side),
                                      b.border_nodes(side))
    np.testing.assert_array_equal(a.all_border_nodes, b.all_border_nodes)


@pytest.mark.parametrize("ngl,nelem", MESHES)
def test_element_matrices_match(ngl, nelem):
    dim = len(nelem)
    corners = JBox.create(ngl, nelem, [0] * dim, [1] * dim).cell_corners[0]
    ma = te.compute_kle_matrices(tb.make_tensor_basis(ngl, dim), corners)
    mb = je.compute_kle_matrices(jb.make_tensor_basis(ngl, dim), corners)
    for name in ("K", "Rw", "Rd"):
        _eq(getattr(ma, name), getattr(mb, name), 1e-14)
    oa = te.compute_operators(tb.make_tensor_basis(ngl, dim), corners)
    ob = je.compute_operators(jb.make_tensor_basis(ngl, dim), corners)
    for name in ("SrT", "DivSrT", "Curl", "weight"):
        _eq(getattr(oa, name), getattr(ob, name), 1e-14)


def _bc_data(dim, kind):
    zero = [0] * dim
    lid = [1.0] + [0] * (dim - 1)
    sides = ["up", "down", "left", "right", "back", "front"][:2 * dim]
    if kind == "no-slip":
        return {"no-slip": {s: (lid if s == "up" else zero) for s in sides}}
    if kind == "mixed":
        return {"no-slip": {"up": lid, "down": zero},
                "free-slip": {s: zero for s in sides[2:]}}
    return {"uniform": {"velocity": lid}}


@pytest.mark.parametrize("ngl,nelem", MESHES)
@pytest.mark.parametrize("kind", ["no-slip", "mixed", "uniform"])
def test_bc_masks_match(ngl, nelem, kind):
    dim = len(nelem)
    a = TBC(TBox.create(ngl, nelem, [0] * dim, [1] * dim),
            _bc_data(dim, kind))
    b = JBC(JBox.create(ngl, nelem, [0] * dim, [1] * dim),
            _bc_data(dim, kind))
    assert a.bc_type == b.bc_type
    assert a.needs_fs_stage == b.needs_fs_stage
    for name in ("dirichlet_mask", "ns_normal_mask", "ns_tang_mask",
                 "free_main", "free_fs", "noslip_nodes", "dirichlet_nodes"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert [(s.name, s.kind) for s in a.sides] \
        == [(s.name, s.kind) for s in b.sides]
    for sa, sb in zip(a.sides, b.sides):
        np.testing.assert_array_equal(sa.nodes, sb.nodes)
        _eq(sa.velocity, sb.velocity)
        _eq(sa.vorticity, sb.vorticity)
        assert sa.normal_axis == sb.normal_axis


def test_port_never_imports_jax():
    """Every submodule of the port imports without jax or pynama_tpu."""
    code = ("import importlib, pkgutil, sys, pynama_tpu_torch as p; "
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'pynama_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert 'pynama_tpu_torch.exp.mm3x' in sys.modules, names; "
            "assert {'pynama_tpu_torch.mesh.gmsh', "
            "'pynama_tpu_torch.mesh.unstructured', "
            "'pynama_tpu_torch.mesh.unstructured3d', "
            "'pynama_tpu_torch.ops.sumfact', "
            "'pynama_tpu_torch.parallel.sharded_engine', "
            "'pynama_tpu_torch.parallel.multihost', "
            "'pynama_tpu_torch.parallel.comm', "
            "'pynama_tpu_torch.ibm.sharded'} <= set(names), names; "
            "assert 'jax' not in sys.modules; "
            "assert 'pynama_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """An edit to a csrc/*.cuh header alone names a new library, so a
    stale build is never loaded (no nvcc needed)."""
    from pynama_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    before = _build._lib_path()
    assert _build._sources() == [str(tmp_path / "k.cu")]
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _build._lib_path() != before
    assert _build.SIGNATURES.keys() >= {
        "pn_fused_apply_f32", "pn_plainmm_f64", "pn_variant_apply_f32",
        "pn_fused3x_f32"}


@pytest.mark.parametrize("card", [False, True])
def test_chip_smoke_alone_exits_without_result(tmp_path, card):
    """chip_smoke.py in a directory that holds nothing else of the repo
    exits non-zero and prints no result line: without a card by its
    no-fallback check, with one (simulated) because the port is missing."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    code = ("import sys, torch; "
            + ("torch.cuda.is_available = lambda: True; " if card else "")
            + "import chip_smoke; sys.exit(chip_smoke.main())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert ("No module named 'pynama_tpu_torch'" if card
            else "is_available() is False") in r.stderr
