"""Port parity on unstructured 3D meshes (gmsh hexes): the HexMesh tables
against the JAX package's, the trilinear-map consistency of the node
placement, borders and normals, and the engine and short transients on
distorted hexes against the JAX package (float64 on the CPU; tolerances
as in test_torch_unstructured.py).
"""
import numpy as np
import pytest
import torch

from pynama_tpu.mesh import HexMesh as JHexMesh
from pynama_tpu_torch.basis.quadrature import lobatto_points
from pynama_tpu_torch.cases import Problem as TProblem
from pynama_tpu_torch.mesh import BoxMesh, HexMesh
from tests.msh_fixtures import grid_hex_mesh
from test_torch_unstructured import (F64, OPTS, TG3D, check_operators,
                                     check_solve_and_rhs, engine_case,
                                     gmsh_config, transients_match,
                                     write_mesh)

torch.set_num_threads(1)

ZERO = [0, 0, 0]


def make_hex(ngl=4, n=(3, 2, 2), distort=0.15, seed=0):
    v, h, s = grid_hex_mesh(*n, distort=distort, seed=seed)
    return HexMesh.create(ngl, v, h, s), JHexMesh.create(ngl, v, h, s)


def expected_nodes(nx, ny, nz, ngl):
    V = (nx + 1) * (ny + 1) * (nz + 1)
    E = (nx * (ny + 1) * (nz + 1) + ny * (nx + 1) * (nz + 1)
         + nz * (nx + 1) * (ny + 1))
    F = (nx + 1) * ny * nz + (ny + 1) * nx * nz + (nz + 1) * nx * ny
    C = nx * ny * nz
    k = ngl - 2
    return V + E * k + F * k * k + C * k ** 3


@pytest.mark.parametrize("ngl", [2, 3, 4, 6])
@pytest.mark.parametrize("distort", [0.0, 0.15])
def test_hex_mesh_tables_match(ngl, distort):
    m, jm = make_hex(ngl=ngl, distort=distort, seed=2)
    assert m.n_nodes == jm.n_nodes == expected_nodes(3, 2, 2, ngl)
    for name in ("cells_gmsh", "cells_tensor", "edges", "cell_nodes",
                 "incidence", "coords", "cell_corners", "all_border_nodes"):
        np.testing.assert_array_equal(getattr(m, name), getattr(jm, name),
                                      err_msg=name)
    assert m.n_faces == jm.n_faces
    assert m.border_name_list == jm.border_name_list
    for name in m.border_name_list:
        np.testing.assert_array_equal(m.border_nodes(name),
                                      jm.border_nodes(name))
        np.testing.assert_array_equal(m.border_outward_normals(name),
                                      jm.border_outward_normals(name))
        assert m.border_normal_axis(name) == jm.border_normal_axis(name)
    assert m.node_separation() == jm.node_separation()
    assert (m.dim, m.dim_w, m.dim_s, m.is_box, m.is_uniform) \
        == (3, 3, 6, False, False)


def test_negative_hex_flipped():
    """A hex given with its bottom and top faces swapped (negative
    Jacobian) is flipped as the JAX package flips it."""
    v, h, s = grid_hex_mesh(2, 1, 1)
    h = h.copy()
    h[0] = np.concatenate([h[0, 4:], h[0, :4]])
    m, jm = HexMesh.create(3, v, h, s), JHexMesh.create(3, v, h, s)
    np.testing.assert_array_equal(m.cells_gmsh, jm.cells_gmsh)
    np.testing.assert_array_equal(m.cell_nodes, jm.cell_nodes)


def test_coords_consistent_with_trilinear_map():
    """Every cell's nodes coincide with that cell's own trilinear corner
    map at the GLL grid: shared faces and edges serve all adjacent cells,
    which catches any of the 8 face orientations going wrong."""
    m, _ = make_hex(ngl=5, n=(3, 3, 2), distort=0.2)
    N = m.ngl
    t = (lobatto_points(N)[0] + 1) / 2
    t0 = t[:, None, None, None]
    t1 = t[None, :, None, None]
    t2 = t[None, None, :, None]
    cc = m.cell_corners.reshape(-1, 2, 2, 2, 3)
    w = [(1 - t0, t0), (1 - t1, t1), (1 - t2, t2)]
    for c in range(m.n_cells):
        tri = sum(w[0][i] * w[1][j] * w[2][k] * cc[c, i, j, k]
                  for i in (0, 1) for j in (0, 1) for k in (0, 1))
        np.testing.assert_allclose(
            m.coords[m.cell_nodes[c]].reshape(N, N, N, 3), tri, atol=1e-13)


def test_borders_and_counts_match_box():
    m, _ = make_hex(ngl=4, n=(2, 2, 2), distort=0.0)
    b = BoxMesh.create(4, (2, 2, 2), (0, 0, 0), (1, 1, 1))
    assert (m.n_nodes, m.n_cells) == (b.n_nodes, b.n_cells)
    left = m.border_nodes("left")
    assert (np.abs(m.coords[left][:, 0]) < 1e-14).all()
    assert len(left) == (2 * 3 + 1) ** 2
    assert [m.border_normal_axis(s) for s in ("left", "up", "front")] \
        == [0, 1, 2]
    np.testing.assert_allclose(m.border_outward_normals("front"),
                               np.tile([0.0, 0.0, 1.0], (4, 1)), atol=1e-14)


# --------------------------------------------------------------- the engine
def hex_cases(tmp_dir):
    tg = write_mesh(tmp_dir / "tg.msh", "hex", (2, 2, 2), 0.12, seed=1)
    cav = write_mesh(tmp_dir / "cav.msh", "hex", (2, 2, 1), 0.1, seed=2)
    return {
        "hex-tg3d": (gmsh_config(tg, 3, TG3D, TG3D, TG3D, rho=0.5), {}),
        "hex-tg3d-dense": (gmsh_config(tg, 3, TG3D, TG3D, TG3D, rho=0.5),
                           dict(sumfact=False)),
        "hex-cavity": (gmsh_config(cav, 3, {"no-slip": {
            "up": [1, 0, 0], "down": ZERO, "left": ZERO, "right": ZERO,
            "back": ZERO, "front": ZERO}}, ic={"vorticity": ZERO}), {}),
    }


@pytest.mark.parametrize("name", ["hex-tg3d", "hex-tg3d-dense",
                                  "hex-cavity"])
@pytest.mark.parametrize("op", ["apply_K", "curl", "srt", "div_srt",
                                "vtensv", "apply_velocity_bc"])
def test_hex_engine_operators_match(tmp_path_factory, name, op):
    pj, tops, _, _ = engine_case(tmp_path_factory, name, hex_cases)
    assert (tops.sumfact is None) == name.endswith("dense")
    check_operators(pj, tops, op)


@pytest.mark.parametrize("name", ["hex-tg3d", "hex-cavity"])
def test_hex_solve_kle_and_rhs_match(tmp_path_factory, name):
    pj, tops, _, _ = engine_case(tmp_path_factory, name, hex_cases)
    check_solve_and_rhs(pj, tops)


@pytest.mark.parametrize("solver", ["cg", "direct"])
def test_hex_transient_matches(tmp_path, solver):
    """The 3D Taylor-Green transient on distorted hexes: the engine (CG,
    sumfact K, gather DSS) and the global layout's direct solve, against
    the JAX package."""
    path = write_mesh(tmp_path / "h.msh", "hex", (2, 2, 2), 0.12)
    cfg = gmsh_config(path, 3, TG3D, TG3D, TG3D, rho=0.5, steps=3)
    pt = transients_match(cfg, solver=solver, cg_rtol=1e-12,
                          cg_maxiter=4000)
    assert (pt.engine_ops is not None) == (solver == "cg")


def test_uniform_flow_distorted_hex(tmp_path):
    """A distorted hex mesh reproduces a uniform flow to 1e-10 (direct and
    engine CG)."""
    path = write_mesh(tmp_path / "u.msh", "hex", (3, 3, 3), 0.12)
    cfg = gmsh_config(path, 3, {"uniform": {"velocity": [4, 0, 0],
                                            "vorticity": ZERO}},
                      ic={"velocity": [4, 0, 0]})
    for solver in ("direct", "cg"):
        p = TProblem(cfg, device="cpu", dtype=F64, solver=solver,
                     cg_rtol=1e-13, cg_maxiter=4000)
        p.setUp()
        assert type(p.mesh).__name__ == "HexMesh"
        _, vel = p.solve_kle(torch.zeros((p.mesh.n_nodes, 3), dtype=F64),
                             p.vel, 0.0)
        exact = np.tile([4.0, 0, 0], (p.mesh.n_nodes, 1))
        assert np.linalg.norm(vel.numpy() - exact) < 1e-10, solver


def test_no_slip_cavity_hex_matches(tmp_path):
    """Axis-aligned hex walls carry the two-stage no-slip solve on the
    engine, as in the JAX package."""
    path = write_mesh(tmp_path / "c.msh", "hex", (2, 2, 2), 0.0)
    cfg = gmsh_config(path, 3, {"no-slip": {
        "up": [1, 0, 0], "down": ZERO, "left": ZERO, "right": ZERO,
        "back": ZERO, "front": ZERO}}, ic={"vorticity": ZERO}, steps=3,
        end_time=0.005)
    pt = transients_match(cfg, dt0=1e-4, tol=1e-4, **OPTS)
    assert pt.engine_ops.is_ns and pt.engine_ops.sumfact is not None
    assert np.abs(pt.vel.numpy()).max() > 1e-8
