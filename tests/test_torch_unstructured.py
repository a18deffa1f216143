"""Port parity on unstructured 2D meshes (gmsh quads): the mesh tables,
the gather DSS and the per-element `emm`, `LocalOp`, the engine fed the
JAX package's operator through `ops_from_numpy`, short transients on both
layouts, the box-mesh equivalences of tests/test_unstructured.py (port
against port) and a gmsh case file through `run_case`.

Meshes come from tests/msh_fixtures.py with interior vertices distorted
from a numpy seed; inputs are drawn from numpy seeds. Float64 on the CPU:
mesh tables equal exactly; DSS/emm within 1e-12 relative; engine
operators, KLE solves and rhs within 1e-10; transients at
tests/test_unstructured.py's tolerances (rtol 1e-6, atol 1e-9, equal
accepted steps). The helpers here also serve test_torch_hex_mesh.py and
test_torch_sumfact.py.
"""
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynama_tpu.cases import Problem as JProblem
from pynama_tpu.engine import local_engine as JE
from pynama_tpu.mesh import UnstructuredMesh as JUnstructuredMesh
from pynama_tpu.ops import local as JL
from pynama_tpu_torch.basis.quadrature import lobatto_points
from pynama_tpu_torch.cases import Problem as TProblem
from pynama_tpu_torch.engine import local_engine as TE
from pynama_tpu_torch.mesh import UnstructuredMesh
from pynama_tpu_torch.ops import local as TL
from pynama_tpu_torch.ops.apply import (apply_op, assembled_diagonal,
                                        make_element_op)
from tests.msh_fixtures import (grid_hex_mesh, grid_quad_mesh, write_msh22,
                                write_msh22_3d, write_msh41)

torch.set_num_threads(1)

F64 = torch.float64
OPTS = dict(solver="cg", cg_rtol=1e-13, cg_maxiter=4000)
TG = {"custom-func": {"name": "taylor_green"}}
TG3D = {"custom-func": {"name": "taylor_green3d"}}


# ------------------------------------------------------------------ helpers
def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.size == b.size == 0:
        return 0.0
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-300)


def dup_spread(y, cell_nodes, ncomp):
    """max over global dofs of (max - min) over the dof's slots."""
    y = np.asarray(y).reshape(-1, ncomp)
    flat = np.asarray(cell_nodes).ravel()
    n = int(flat.max()) + 1
    hi = np.full((n, ncomp), -np.inf)
    lo = np.full((n, ncomp), np.inf)
    np.maximum.at(hi, flat, y)
    np.minimum.at(lo, flat, y)
    return float((hi - lo).max())


def write_mesh(path, kind, n, distort, seed=0, writer=None):
    """A gmsh file of an (n) grid of quads ('quad') or hexes ('hex')."""
    if kind == "hex":
        write_msh22_3d(str(path), *grid_hex_mesh(*n, distort=distort,
                                                 seed=seed))
    else:
        (writer or write_msh22)(str(path), *grid_quad_mesh(
            *n, distort=distort, seed=seed))
    return str(path)


def gmsh_config(path, ngl, bc, ic=None, tests=None, rho=1.0, mu=0.01,
                steps=None, end_time=0.02):
    cfg = {"name": "unstruct",
           "material-properties": {"rho": rho, "mu": mu},
           "domain": {"ngl": ngl, "gmsh-file": path},
           "boundary-conditions": bc,
           "initial-conditions": ic or {"vorticity": [0]}}
    if tests:
        cfg["tests"] = tests
    if steps:
        cfg["time-solver"] = {"start-time": 0, "end-time": end_time,
                              "max-steps": steps}
    return cfg


def engine_arrays(ops) -> dict:
    """EngineOps (either package) -> {field key: numpy array}, over
    ARRAY_FIELDS, UNSTRUCTURED_FIELDS on an unstructured mesh and
    SUMFACT_FIELDS when K is sum-factorized."""
    keys = TE.ARRAY_FIELDS
    if not ops.lay_v.structured:
        keys += TE.UNSTRUCTURED_FIELDS
    if ops.sumfact is not None:
        keys += TE.SUMFACT_FIELDS
    out = {}
    for key in keys:
        obj = ops
        for part in key.split("."):
            obj = getattr(obj, part)
        if key.endswith(".perms"):
            lay = getattr(ops, key.split(".")[0])
            obj = np.stack([np.asarray(p) for p in obj]) if len(obj) \
                else np.zeros((0, lay.nnc), dtype=np.int64)
        elif isinstance(obj, torch.Tensor):
            obj = obj.numpy()
        out[key] = np.asarray(obj)
    return out


def port_ops(jops):
    """The port's EngineOps on the CPU in float64, fed the JAX package's
    operator array for array."""
    return TE.ops_from_numpy(
        engine_arrays(jops), ngl=jops.ngl, nelem=jops.nelem, dim=jops.dim,
        dim_w=jops.dim_w, dim_s=jops.dim_s, is_ns=jops.is_ns,
        cg_rtol=jops.cg_rtol, cg_atol=jops.cg_atol,
        cg_maxiter=jops.cg_maxiter, device="cpu", dtype=F64,
        func_sides=jops.func_sides, pc=jops.pc, krylov=jops.krylov,
        structured=jops.lay_v.structured)


def fields(pj, seed):
    rng = np.random.default_rng(seed)
    vel = pj.to_local(rng.standard_normal((pj.mesh.n_nodes, pj.dim)))
    vort = pj.to_local(rng.standard_normal((pj.mesh.n_nodes, pj.dim_w)))
    return np.array(vel), np.array(vort)


def check_operators(pj, tops, op, t=0.3):
    """One engine operator (or BC writer) of the JAX package's EngineOps
    against the port's on the same random fields."""
    vel, vort = fields(pj, 1)
    if op == "div_srt":
        x = np.array(pj.to_local(np.random.default_rng(2).standard_normal(
            (pj.mesh.n_nodes, pj.dim_s))))
    else:
        x = vort if op == "apply_vorticity_bc" else vel
    args = (t,) if op.endswith("_bc") else ()
    want = getattr(JE, op)(pj.engine_ops, jnp.asarray(x), *args)
    got = getattr(TE, op)(tops, torch.as_tensor(x), *args)
    assert rel(got.numpy(), want) <= 1e-10, op


def check_solve_and_rhs(pj, tops, t=0.0):
    """solve_kle_local and rhs_local of both packages on the same random
    fields, within 1e-10."""
    vel, vort = fields(pj, 3)
    _, vj = JE.solve_kle_local(pj.engine_ops, jnp.asarray(vort),
                               jnp.asarray(vel), t)
    _, vt = TE.solve_kle_local(tops, torch.as_tensor(vort),
                               torch.as_tensor(vel), t)
    assert rel(vt.numpy(), vj) <= 1e-10
    fj, uj = JE.rhs_local(pj.engine_ops, t, jnp.asarray(vort),
                          jnp.asarray(vel))
    ft, ut = TE.rhs_local(tops, t, torch.as_tensor(vort),
                          torch.as_tensor(vel))
    assert rel(ut.numpy(), uj) <= 1e-10
    assert rel(ft.numpy(), fj) <= 1e-10


def transients_match(cfg, dt0=1e-3, tol=1e-5, **opts):
    """The same transient through both packages: equal accepted steps and
    end times, fields within rtol 1e-6, atol 1e-9. Returns the port's
    Problem."""
    pj = JProblem(cfg, **opts)
    pj.setUp()
    tj, sj = pj.start_solver(dt0=dt0, atol=tol, rtol=tol)
    pt = TProblem(cfg, device="cpu", dtype=F64, **opts)
    pt.setUp()
    tt, st = pt.start_solver(dt0=dt0, atol=tol, rtol=tol)
    assert st == sj >= 2 and abs(tt - tj) <= 1e-12
    assert (pt.engine_ops is None) == (pj.engine_ops is None)
    np.testing.assert_allclose(pt.vort.numpy(), np.asarray(pj.vort),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(pt.vel.numpy(), np.asarray(pj.vel),
                               rtol=1e-6, atol=1e-9)
    return pt


def coord_order(coords):
    r = np.round(np.asarray(coords), 10)
    return np.lexsort(tuple(r[:, d] for d in reversed(range(r.shape[1]))))


# ---------------------------------------------------------------- the mesh
@pytest.mark.parametrize("ngl", [2, 3, 5, 8])
@pytest.mark.parametrize("distort", [0.0, 0.12])
def test_quad_mesh_tables_match(ngl, distort):
    v, q, l = grid_quad_mesh(4, 3, distort=distort, seed=5)
    m, jm = UnstructuredMesh.create(ngl, v, q, l), \
        JUnstructuredMesh.create(ngl, v, q, l)
    k = ngl - 2
    assert m.n_nodes == jm.n_nodes == 20 + 31 * k + 12 * k * k
    for name in ("cells_ccw", "cells_tensor", "edges", "cell_nodes",
                 "incidence", "coords", "cell_corners", "all_border_nodes"):
        np.testing.assert_array_equal(getattr(m, name), getattr(jm, name),
                                      err_msg=name)
    assert m.border_name_list == jm.border_name_list
    for name in m.border_name_list:
        np.testing.assert_array_equal(m.border_nodes(name),
                                      jm.border_nodes(name))
        np.testing.assert_array_equal(m.border_outward_normals(name),
                                      jm.border_outward_normals(name))
        assert m.border_normal_axis(name) == jm.border_normal_axis(name)
    assert m.node_separation() == jm.node_separation()
    for a, b in zip(m.nodes_over_line("x", 0.0),
                    jm.nodes_over_line("x", 0.0)):
        np.testing.assert_array_equal(a, b)
    assert (m.dim, m.dim_w, m.dim_s, m.is_box, m.is_uniform) \
        == (2, 1, 3, False, False)


def test_orientation_canonicalized():
    """A clockwise-input quad is flipped to positive orientation, as in the
    JAX package."""
    v = np.array([[0.0, 0], [1, 0], [1, 1], [0, 1]])
    cw = np.array([[0, 3, 2, 1]])
    m = UnstructuredMesh.create(3, v, cw)
    np.testing.assert_array_equal(
        m.cells_ccw, JUnstructuredMesh.create(3, v, cw).cells_ccw)
    cc = m.cell_corners[0]
    J = np.stack([cc[2] - cc[0], cc[1] - cc[0]], axis=1)
    assert np.linalg.det(J) > 0


def test_coords_consistent_with_bilinear_map():
    """Each cell's nodes lie at that cell's own bilinear corner map at the
    GLL grid: a shared edge's nodes serve both cells."""
    v, q, l = grid_quad_mesh(3, 3, distort=0.2)
    m = UnstructuredMesh.create(5, v, q, l)
    N = m.ngl
    t = (lobatto_points(N)[0] + 1) / 2
    t0, t1 = t[:, None, None], t[None, :, None]
    cc = m.cell_corners
    for c in range(m.n_cells):
        local = ((1 - t0) * (1 - t1) * cc[c, 0] + (1 - t0) * t1 * cc[c, 1]
                 + t0 * (1 - t1) * cc[c, 2] + t0 * t1 * cc[c, 3])
        np.testing.assert_allclose(
            m.coords[m.cell_nodes[c]].reshape(N, N, 2), local, atol=1e-13)


# ------------------------------------------------------- gather DSS and emm
@pytest.mark.parametrize("kind,ngl", [("quad", 3), ("quad", 5), ("hex", 3),
                                      ("hex", 4)])
@pytest.mark.parametrize("cin,cout", [(1, 2), (2, 3), (3, 1)])
def test_gather_dss_and_emm_match(tmp_path, kind, ngl, cin, cout):
    """Per-element emm and the gather DSS against the JAX package's; every
    duplicated slot bitwise equal; local_dot on the result."""
    from pynama_tpu.mesh import mesh_from_gmsh as jmesh
    from pynama_tpu_torch.mesh import mesh_from_gmsh as tmesh
    n = (2, 3, 2) if kind == "hex" else (4, 3)
    path = write_mesh(tmp_path / "m.msh", kind, n, 0.12, seed=1)
    m, jm = tmesh(path, ngl), jmesh(path, ngl)
    nn, E = m.nnode_el, m.n_cells
    rng = np.random.default_rng(ngl * 10 + cin)
    t = rng.standard_normal((E, nn * cin))
    matT = rng.standard_normal((E, nn * cin, nn * cout))
    jlay = JL.make_local_layout(jm, cout, dtype=jnp.float64)
    tlay = TL.make_local_layout(m, cout, device="cpu", dtype=F64)
    assert not tlay.structured and tlay.nelem == (E,) and tlay.dim == m.dim
    np.testing.assert_array_equal(tlay.incidence.numpy(),
                                  np.asarray(jlay.incidence))
    np.testing.assert_array_equal(tlay.cell_nodes.numpy(),
                                  np.asarray(jlay.cell_nodes))
    np.testing.assert_array_equal(tlay.inv_mult.numpy(),
                                  np.asarray(jlay.inv_mult))
    zj = JL.emm(jnp.asarray(t), jnp.asarray(matT))
    zt = TL.emm(torch.as_tensor(t), torch.as_tensor(matT))
    assert rel(zt.numpy(), zj) <= 1e-12
    yj = JL.dss(jlay, zj)
    yt = TL.dss(tlay, torch.as_tensor(np.array(zj)))
    assert rel(yt.numpy(), yj) <= 1e-12
    assert dup_spread(yt.numpy(), m.cell_nodes, cout) == 0.0
    np.testing.assert_allclose(yt.numpy(), TL.dss_np(m, np.asarray(zj),
                                                     cout), rtol=1e-12,
                               atol=1e-12)
    got = float(TL.local_dot(tlay, yt, yt))
    want = float(JL.local_dot(jlay, yj, yj))
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("kind", ["quad", "hex"])
@pytest.mark.parametrize("shared", [True, False])
def test_local_op_matches(tmp_path, kind, shared):
    """LocalOp against the global ElementOp (apply and assembled diagonal)
    and, for a shared matrix, against the JAX package's LocalOp."""
    from pynama_tpu.mesh import mesh_from_gmsh as jmesh
    from pynama_tpu_torch.mesh import mesh_from_gmsh as tmesh
    n = (2, 2, 3) if kind == "hex" else (3, 4)
    path = write_mesh(tmp_path / "m.msh", kind, n, 0.1, seed=2)
    m = tmesh(path, 3)
    d = m.dim
    nd = m.nnode_el * d
    rng = np.random.default_rng(4)
    mat = rng.standard_normal((nd, nd) if shared else (m.n_cells, nd, nd))
    x = rng.standard_normal((m.n_nodes, d))
    lo = TL.make_local_layout(m, d, device="cpu", dtype=F64)
    op = TL.make_local_op(mat, lo, device="cpu", dtype=F64)
    y = TL.apply_local_op(op, torch.as_tensor(TL.to_local(m, x)))
    eop = make_element_op(mat, m.cell_nodes, m.incidence, d, d, m.n_nodes,
                          device="cpu", dtype=F64)
    y_ref = apply_op(eop, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(TL.to_global(m, y.numpy(), d), y_ref,
                               rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(y.numpy(), TL.to_local(m, y_ref), rtol=1e-11,
                               atol=1e-11)
    diag = TL.to_global(m, TL.local_diagonal(op).numpy(), d)
    np.testing.assert_allclose(diag, assembled_diagonal(eop).numpy(),
                               rtol=1e-11, atol=1e-11)
    if shared:
        jm = jmesh(path, 3)
        jop = JL.make_local_op(mat, JL.make_local_layout(jm, d, jnp.float64),
                               dtype=jnp.float64)
        yj = JL.apply_local_op(jop, jnp.asarray(TL.to_local(m, x)))
        assert rel(y.numpy(), yj) <= 1e-12
        assert rel(TL.local_diagonal(op).numpy(),
                   JL.local_diagonal(jop)) <= 1e-12


# --------------------------------------------------------------- the engine
_CASES = {}


def quad_cases(tmp_dir):
    """name -> config of the quad engine cases (meshes in tmp_dir)."""
    tg = write_mesh(tmp_dir / "tg.msh", "quad", (4, 3), 0.12, seed=3)
    cav = write_mesh(tmp_dir / "cav.msh", "quad", (3, 3), 0.1, seed=4)
    return {
        "tg": (gmsh_config(tg, 4, TG, TG, TG), {}),
        "tg-dense": (gmsh_config(tg, 4, TG, TG, TG), dict(sumfact=False)),
        "cavity": (gmsh_config(cav, 3, {"no-slip": {
            "up": [1, 0], "down": [0, 0], "left": [0, 0],
            "right": [0, 0]}}), {}),
    }


def engine_case(tmp_path_factory, name, cases_fn=quad_cases):
    """(JAX Problem, port ops fed from its EngineOps, config, options)."""
    if name not in _CASES:
        cfg, extra = cases_fn(tmp_path_factory.mktemp("mesh"))[name]
        pj = JProblem(cfg, **OPTS, **extra)
        pj.setUp()
        _CASES[name] = (pj, port_ops(pj.engine_ops), cfg, extra)
    return _CASES[name]


@pytest.mark.parametrize("name", ["tg", "tg-dense", "cavity"])
def test_build_engine_matches(tmp_path_factory, name):
    """The port's own setup builds the operator the JAX package builds,
    array for array; K is sum-factorized unless asked otherwise."""
    pj, _, cfg, extra = engine_case(tmp_path_factory, name)
    pt = TProblem(cfg, device="cpu", dtype=F64, **OPTS, **extra)
    pt.setUp()
    got, want = engine_arrays(pt.engine_ops), engine_arrays(pj.engine_ops)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert rel(got[key], want[key]) <= 1e-14, key
    ops = pt.engine_ops
    assert ops.nelem == pj.engine_ops.nelem == (pt.mesh.n_cells,)
    assert not ops.lay_v.structured and ops.pc == "jacobi"
    assert (ops.sumfact is None) == (name == "tg-dense")
    assert ops.KT.numel() == (0 if ops.sumfact is not None
                              else pt.mesh.n_cells * (pt.mesh.nnode_el * 2)
                              ** 2)


@pytest.mark.parametrize("name", ["tg", "tg-dense", "cavity"])
@pytest.mark.parametrize("op", ["apply_K", "curl", "srt", "div_srt",
                                "vtensv", "apply_velocity_bc",
                                "apply_vorticity_bc"])
def test_engine_operators_match(tmp_path_factory, name, op):
    pj, tops, _, _ = engine_case(tmp_path_factory, name)
    check_operators(pj, tops, op)


@pytest.mark.parametrize("name", ["tg", "tg-dense", "cavity"])
def test_solve_kle_and_rhs_match(tmp_path_factory, name):
    pj, tops, _, _ = engine_case(tmp_path_factory, name)
    check_solve_and_rhs(pj, tops)


# --------------------------------------------------------------- transients
@pytest.mark.parametrize("engine", [True, False])
def test_transient_distorted_matches(tmp_path, engine):
    """The Taylor-Green transient on a distorted quad mesh, engine
    (sumfact K, gather DSS) and global layout, against the JAX package."""
    path = write_mesh(tmp_path / "e.msh", "quad", (4, 4), 0.12)
    cfg = gmsh_config(path, 4, TG, TG, TG, steps=4)
    pt = transients_match(cfg, solver="cg", cg_rtol=1e-12, cg_maxiter=4000,
                          engine=engine)
    assert (pt.engine_ops is not None) == engine
    if engine:
        assert pt.engine_ops.sumfact is not None
        assert pt.engine_ops.KT.numel() == 0


def test_no_slip_cavity_matches(tmp_path):
    """Axis-aligned unstructured walls carry the two-stage no-slip solve,
    through "auto" (the direct solve at this size), as in the JAX package."""
    path = write_mesh(tmp_path / "c.msh", "quad", (3, 3), 0.0)
    cfg = gmsh_config(path, 3, {"no-slip": {
        "up": [1, 0], "down": [0, 0], "left": [0, 0], "right": [0, 0]}},
        steps=3, end_time=0.005)
    pt = transients_match(cfg, dt0=1e-4, tol=1e-4)
    assert pt.solver_method == "direct" and pt.engine_ops is None
    assert np.abs(pt.vel.numpy()).max() > 1e-8


def test_uniform_flow_distorted(tmp_path):
    """Constant velocity is in the bilinear space: a distorted mesh
    reproduces it to 1e-10 (the reference's tolerance)."""
    path = write_mesh(tmp_path / "d.msh", "quad", (4, 4), 0.2)
    cfg = gmsh_config(path, 4, {"uniform": {"velocity": [4, 0],
                                            "vorticity": [0]}})
    for solver in ("direct", "cg"):
        p = TProblem(cfg, device="cpu", dtype=F64, solver=solver,
                     cg_rtol=1e-13, cg_maxiter=4000)
        p.setUp()
        _, vel = p.solve_kle(torch.zeros((p.mesh.n_nodes, 1), dtype=F64),
                             p.vel, 0.0)
        exact = np.tile([4.0, 0.0], (p.mesh.n_nodes, 1))
        assert np.linalg.norm(vel.numpy() - exact) < 1e-10, solver


def test_kle_errors_match_p_convergence(tmp_path):
    """kle_errors of the direct solve on a distorted Taylor-Green mesh at
    ngl 3, 5, 7: equal to the JAX package's, and falling with ngl."""
    path = write_mesh(tmp_path / "tg.msh", "quad", (4, 4), 0.12,
                      writer=write_msh41)
    errs = []
    for ngl in (3, 5, 7):
        cfg = gmsh_config(path, ngl, TG, TG, TG)
        pt = TProblem(cfg, device="cpu", dtype=F64, solver="direct")
        pt.setUp()
        pj = JProblem(cfg, solver="direct")
        pj.setUp()
        et, ej = pt.kle_errors([0.5])[0], pj.kle_errors([0.5])[0]
        assert abs(et - ej) <= 1e-8 * ej
        errs.append(et)
    assert errs[0] > errs[1] > errs[2] and errs[2] < 1e-4


def test_unstructured_matches_box(tmp_path):
    """An undistorted grid .msh gives the BoxMesh solution (node orders
    differ: fields compared through coordinates)."""
    path = write_mesh(tmp_path / "g.msh", "quad", (4, 4), 0.0)
    box = {"name": "box", "material-properties": {"rho": 1, "mu": 0.01},
           "domain": {"ngl": 4, "box-mesh": {
               "nelem": [4, 4], "lower": [0, 0], "upper": [1, 1]}},
           "boundary-conditions": TG,
           "initial-conditions": {"vorticity": [0]}, "tests": TG}
    out = {}
    for name, cfg in (("u", gmsh_config(path, 4, TG, tests=TG)),
                      ("b", box)):
        p = TProblem(cfg, device="cpu", dtype=F64, solver="direct")
        p.setUp()
        _, ew = p.exact_fields(0.3)
        _, vel = p.solve_kle(ew, p.vel, 0.3)
        out[name] = (p.mesh.coords, vel.numpy())
    iu, ib = coord_order(out["u"][0]), coord_order(out["b"][0])
    np.testing.assert_allclose(out["u"][0][iu], out["b"][0][ib], atol=1e-12)
    np.testing.assert_allclose(out["u"][1][iu], out["b"][1][ib], atol=1e-9)


def test_engine_transient_matches_box(tmp_path):
    """The undistorted gmsh Taylor-Green transient on the engine (sumfact
    K, gather DSS) equals the BoxMesh engine transient (K1's plain
    version), fields compared through coordinates."""
    path = write_mesh(tmp_path / "b.msh", "quad", (4, 4), 0.0)
    ts = {"start-time": 0, "end-time": 0.02, "max-steps": 4}
    cfg_u = dict(gmsh_config(path, 4, TG, TG), **{"time-solver": ts})
    cfg_b = {"name": "box", "material-properties": {"rho": 1, "mu": 0.01},
             "domain": {"ngl": 4, "box-mesh": {
                 "nelem": [4, 4], "lower": [0, 0], "upper": [1, 1]}},
             "boundary-conditions": TG, "initial-conditions": TG,
             "time-solver": ts}
    out = {}
    for name, cfg in (("u", cfg_u), ("b", cfg_b)):
        p = TProblem(cfg, device="cpu", dtype=F64, solver="cg",
                     cg_rtol=1e-12, cg_maxiter=4000)
        p.setUp()
        steps = p.start_solver(dt0=1e-3, atol=1e-5, rtol=1e-5)[1]
        out[name] = (steps, p.mesh.coords, p.vort.numpy())
    assert out["u"][0] == out["b"][0]
    iu, ib = coord_order(out["u"][1]), coord_order(out["b"][1])
    np.testing.assert_allclose(out["u"][2][iu], out["b"][2][ib], rtol=1e-6,
                               atol=1e-9)


# ------------------------------------------------------ options and the CLI
def test_options_on_gmsh(tmp_path, caplog):
    """"auto" resolves by size (direct here, no engine); pc="fdm" falls
    back to Jacobi with a warning; fused=True is logged and takes the
    per-element route, bitwise the fused=False result."""
    path = write_mesh(tmp_path / "o.msh", "quad", (3, 3), 0.1)
    cfg = gmsh_config(path, 3, TG, TG, TG)
    p = TProblem(cfg, device="cpu", dtype=F64)
    p.setUp()
    assert p.solver_method == "direct" and p.engine_ops is None
    with caplog.at_level(logging.INFO, logger="pynama_tpu_torch.engine"):
        pf = TProblem(cfg, device="cpu", dtype=F64, solver="cg", pc="fdm")
        pf.setUp()
    assert pf.engine_ops.pc == "jacobi"
    assert "using pc='jacobi'" in caplog.text
    assert "box meshes only" in caplog.text
    p0 = TProblem(cfg, device="cpu", dtype=F64, solver="cg", fused=False)
    p0.setUp()
    vel, vort = fields(p0, 5)
    for op in ("apply_K", "curl", "srt"):
        a = getattr(TE, op)(pf.engine_ops, torch.as_tensor(vel))
        b = getattr(TE, op)(p0.engine_ops, torch.as_tensor(vel))
        assert torch.equal(a, b), op


def test_gmsh_case_through_run_case(tmp_path, monkeypatch):
    """A case file with gmsh-file through both CLIs (2 steps, CG): the same
    snapshots; the port's fields equal Problem driven directly."""
    import yaml

    from pynama_tpu_torch import run_case as trc
    from test_torch_cli import assert_dirs_match, run_both

    mesh = write_mesh(tmp_path / "cli.msh", "quad", (3, 3), 0.12)
    cfg = dict(gmsh_config(mesh, 3, TG, TG, TG, steps=2, end_time=1.0),
               **{"save-dir": "gmsh-out"})
    case = tmp_path / "gmsh-case.yaml"
    case.write_text(yaml.dump(cfg))
    args = ["-case", str(case), "-log", "WARNING", "-solver", "cg",
            "-cg-rtol", "1e-12", "-dt0", "1e-3"]
    dj, dt, (p, t, steps) = run_both(tmp_path, monkeypatch, args)
    assert steps == 2 and p.engine_ops.sumfact is not None
    names = assert_dirs_match(dj / "gmsh-out", dt / "gmsh-out")
    assert sum(n.startswith("vec-data-") for n in names) == 2
    pd = TProblem(trc.load_case(str(case)), device="cpu", dtype=F64,
                  solver="cg", cg_rtol=1e-12)
    pd.setUp()
    assert pd.start_solver(dt0=1e-3) == (t, steps)
    np.testing.assert_array_equal(pd.vort.numpy(), p.vort.numpy())
    np.testing.assert_array_equal(pd.vel.numpy(), p.vel.numpy())
