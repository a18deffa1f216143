"""Port parity: analytic-function (custom-func) boundary sides, the
global-layout value writers and the incidence table, against pynama_tpu.

Masks, sides and node sets are numpy in both packages and must be equal.
Side values at a time are torch closed forms against jax.numpy ones on the
same float64 coordinates: the Taylor-Green sides bitwise, the flat plate's
(erf, exp) to 1e-13. The writers `apply_velocity`, `apply_vorticity` and
`apply_tangential` take numpy arrays and tensors, as the reference's take
numpy arrays and jax arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.bc import BoundaryConditions as JBC
from pynama_tpu.mesh import BoxMesh as JBox
from pynama_tpu.mesh.box import build_incidence as j_build_incidence
from pynama_tpu_torch.bc import BoundaryConditions as TBC
from pynama_tpu_torch.mesh import BoxMesh as TBox
from pynama_tpu_torch.mesh.box import build_incidence

torch.set_num_threads(1)

T_NU = (0.3, 0.02)
FP = {"custom-func": {"name": "flat_plate"}}
TG = {"custom-func": {"name": "taylor_green"}}

# (dim, bc data): the cases of tests/test_bc.py's custom-func tests, the
# flat-plate-FSNS mix and a function-valued no-slip wall
CASES = {
    "all-tg2d": (2, {"custom-func": {
        "name": "taylor_green",
        "attributes": ["velocity", "vorticity", "alpha"]}}),
    "all-tg3d": (3, {"custom-func": {"name": "taylor_green3d"}}),
    "all-tg2d3d": (3, {"custom-func": {"name": "taylor_green_3d"}}),
    "custom-and-uniform": (2, {"free-slip": {
        "left": TG, "right": [2.0, 0.0], "up": [2.0, 0.0],
        "down": [2.0, 0.0]}}),
    "flat-plate-fsns": (2, {"no-slip": {"down": [0, 1]},
                            "free-slip": {"left": FP, "right": FP,
                                          "up": FP}}),
    "func-wall": (2, {"no-slip": {"down": TG, "up": [1.0, 0.0]},
                      "free-slip": {"left": [0, 0], "right": [0, 0]}}),
}


def _both(name, n=3, ngl=3):
    dim, data = CASES[name]
    args = (ngl, [n] * dim, [0] * dim, [1] * dim)
    tm, jm = TBox.create(*args), JBox.create(*args)
    return tm, TBC(tm, data), jm, JBC(jm, data)


def _bitwise(name):
    return name != "flat-plate-fsns"


def _close(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(float(np.abs(want).max()), 1e-300)
        assert float(np.abs(got - want).max()) <= 1e-13 * scale


@pytest.mark.parametrize("name", sorted(CASES))
def test_masks_and_sides_match(name):
    tm, a, jm, b = _both(name)
    assert a.bc_type == b.bc_type
    assert a.needs_fs_stage == b.needs_fs_stage
    for key in ("dirichlet_mask", "ns_normal_mask", "ns_tang_mask",
                "free_main", "free_fs", "noslip_nodes", "dirichlet_nodes"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    assert [(s.name, s.kind, s.normal_axis) for s in a.sides] \
        == [(s.name, s.kind, s.normal_axis) for s in b.sides]
    for sa, sb in zip(a.sides, b.sides):
        np.testing.assert_array_equal(sa.nodes, sb.nodes)
        assert (sa.func is None) == (sb.func is None)
        if sa.func is None:
            np.testing.assert_array_equal(sa.velocity, sb.velocity)
            np.testing.assert_array_equal(sa.vorticity, sb.vorticity)
            continue
        assert sa.func.__name__.rsplit(".", 1)[-1] \
            == sb.func.__name__.rsplit(".", 1)[-1]
        np.testing.assert_array_equal(sa.coords, sb.coords)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("attr", ["velocity", "vorticity"])
def test_side_values_match(name, attr):
    _, a, _, b = _both(name)
    for sa, sb in zip(a.sides, b.sides):
        _close(sa.values(attr, *T_NU), sb.values(attr, *T_NU),
               _bitwise(name))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("writer", ["apply_velocity", "apply_vorticity",
                                    "apply_tangential"])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_writers_match(name, writer, kind):
    """Each writer on a numpy-seeded field, as numpy and as a tensor,
    against the reference's writer on the same field as a jax array; the
    input is left as it was."""
    tm, a, _, b = _both(name)
    ncomp = a.dim_w if writer == "apply_vorticity" else a.dim
    x = np.random.default_rng(7).standard_normal((tm.n_nodes, ncomp))
    want = np.asarray(getattr(b, writer)(jnp.asarray(x), *T_NU))
    x_in = x.copy() if kind == "numpy" else torch.as_tensor(x)
    got = getattr(a, writer)(x_in, *T_NU)
    assert isinstance(got, np.ndarray if kind == "numpy" else torch.Tensor)
    _close(got, want, _bitwise(name))
    np.testing.assert_array_equal(np.asarray(x_in), x)


def test_writers_keep_tensor_dtype():
    tm, a, _, _ = _both("func-wall")
    x = torch.zeros((tm.n_nodes, 2), dtype=torch.float32)
    for writer in ("apply_velocity", "apply_tangential"):
        out = getattr(a, writer)(x, *T_NU)
        assert out.dtype == torch.float32 and out.abs().max() > 0


@pytest.mark.parametrize("dim,n,ngl", [(2, 3, 3), (2, 2, 5), (3, 2, 3),
                                       (3, 3, 2)])
def test_incidence_matches(dim, n, ngl):
    """build_incidence and BoxMesh.incidence equal the reference's, so the
    FDM gather path reads the same representative slot (column 0, the
    lowest flat slot of each node)."""
    args = (ngl, [n] * dim, [0] * dim, [1] * dim)
    tm, jm = TBox.create(*args), JBox.create(*args)
    got = build_incidence(tm.cell_nodes, tm.n_nodes)
    np.testing.assert_array_equal(
        got, j_build_incidence(jm.cell_nodes, jm.n_nodes))
    np.testing.assert_array_equal(tm.incidence, np.asarray(jm.incidence))
    assert got.dtype == np.int32
    flat = tm.cell_nodes.ravel()
    first = np.array([np.flatnonzero(flat == g)[0]
                      for g in range(tm.n_nodes)])
    np.testing.assert_array_equal(got[:, 0], first)
