"""Port parity: pynama_tpu_torch.bc.walls against pynama_tpu.bc.walls on
the cases of tests/test_walls.py (normals, static/velocity dof splits,
randomized box extents): both packages give the same answers."""
import numpy as np
import pytest

from pynama_tpu.bc.walls import NoSlipWalls as JWalls
from pynama_tpu_torch.bc.walls import NoSlipWalls as TWalls


def _box(seed, dim):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-10, 0, dim)
    hi = lo + rng.uniform(0.5, 10, dim)
    return list(lo), list(hi)


def _state(w):
    """Everything a NoSlipWalls reports, as plain Python values."""
    out = {"len": len(w), "names": w.get_walls_names(),
           "static": list(w.get_static_walls()),
           "with_velocity": list(w.get_walls_with_velocity())}
    for name in w.get_walls_names():
        vals, dofs = w.get_wall_velocity(name)
        wall = w.get_wall_by_side_name(name)
        out[name] = (w.get_wall_normal_by_side_name(name),
                     list(w.get_static_dofs_by_name(name)),
                     [float(v) for v in vals], list(dofs),
                     [v.get_coordinates().tolist() for v in wall.vertices],
                     wall.get_wall_name(), wall.compute_normal())
    return out


BOXES = [(42, 2), (7, 2), (3, 3)]


@pytest.mark.parametrize("seed,dim", BOXES)
@pytest.mark.parametrize("exclude", [(), ("up",), ("left", "down")])
def test_walls_match(seed, dim, exclude):
    lo, hi = _box(seed, dim)
    assert _state(TWalls(lo, hi, exclude)) == _state(JWalls(lo, hi, exclude))


@pytest.mark.parametrize("seed,dim", BOXES)
def test_set_wall_velocity_matches(seed, dim):
    """Nonzero components move from static to velocity dofs, in both."""
    lo, hi = _box(seed, dim)
    vel = [1.5, 0.0] if dim == 2 else [1.0, 0.0, 0.5]
    walls = []
    for cls in (TWalls, JWalls):
        w = cls(lo, hi)
        w.set_wall_velocity("up", vel)
        w.set_wall_velocity("nope", vel)          # unknown side: ignored
        walls.append(_state(w))
    assert walls[0] == walls[1]
    assert walls[0]["with_velocity"] == ["up"]


@pytest.mark.parametrize("cls", [TWalls, JWalls])
def test_invalid_velocity_raises(cls):
    w = cls(*_box(42, 2))
    with pytest.raises(ValueError, match="Velocity not valid"):
        w.get_wall_by_side_name("left").set_wall_velocity([0.0, 0.0])


def test_3d_normals():
    w = TWalls([0, 0, 0], [1, 2, 3])
    assert [w.get_wall_normal_by_side_name(s)
            for s in ("left", "right", "up", "down", "back", "front")] \
        == [0, 0, 1, 1, 2, 2]
    assert repr(w.get_wall_by_side_name("up").vertices[0]) \
        == repr(JWalls([0, 0, 0], [1, 2, 3]).get_wall_by_side_name(
            "up").vertices[0])
