"""No-slip wall bookkeeping for box domains (host numpy).

Carried over from pynama_tpu/bc/walls.py, itself a port of the reference's
`src/common/nswalls.py` (NoSlipWalls / Wall / Vertex): per-side wall
segments on a box, geometric normal computation (via cross product with z,
nswalls.py:249-267), and the static-vs-velocity dof split a no-slip wall
induces — a dof is "static" until a nonzero wall
velocity component claims it (nswalls.py:201-215).

In the reference this module is exercised only by tests
(`src/tests/test_nswalls.py`); the production path derives the same
information from `Directions` in boundary.py. It is kept here for API
parity and as the geometric self-check of the bc layer's normal tables.
"""
from __future__ import annotations

import numpy as np

from pynama_tpu_torch.mesh.box import SIDE_NORMAL_AXIS, SIDE_IS_MAX


class Vertex:
    def __init__(self, coords):
        self.coords = np.asarray(coords, dtype=np.float64)

    def get_coordinates(self) -> np.ndarray:
        return self.coords

    def __repr__(self):
        return f"Vertex({self.coords.tolist()})"


class Wall:
    """One wall: a chain of vertices + the dof bookkeeping."""

    def __init__(self, num: int, vertexs, dim: int):
        self.num = num
        self.dim = dim
        self.vertices = [Vertex(v) for v in vertexs]
        self.name = None
        #: dofs held at zero until a velocity claims them
        self.static_dofs = list(range(dim))
        self.velocity = None
        self.vel_dofs = None

    def __iter__(self):
        for a, b in zip(self.vertices[:-1], self.vertices[1:]):
            yield a, b

    def set_wall_name(self, name: str):
        self.name = name

    def get_wall_name(self):
        return self.name

    def set_wall_velocity(self, vel):
        """Move each nonzero velocity component from static to velocity
        dofs (reference setWallVelocity, nswalls.py:201-215)."""
        vel = np.asarray(vel, dtype=np.float64)
        vels, vel_dofs = [], []
        for dof in list(self.static_dofs):
            if vel[dof] != 0:
                vels.append(vel[dof])
                vel_dofs.append(dof)
                self.static_dofs.remove(dof)
        if not vel_dofs:
            raise ValueError("Velocity not valid")
        self.velocity = np.array(vels)
        self.vel_dofs = vel_dofs

    def get_wall_velocity(self):
        """(values, dofs); a static wall reports zeros on its static dofs
        (reference getWallVelocity, nswalls.py:223-228)."""
        if self.velocity is not None:
            return self.velocity, self.vel_dofs
        return [0] * len(self.static_dofs), self.static_dofs

    def get_static_dofs(self):
        return self.static_dofs

    def compute_normal(self) -> int:
        """Normal AXIS index from segment geometry: |segment x z| has a 1
        in the normal direction (reference computeNormal,
        nswalls.py:249-267; z-walls return 2)."""
        if self.num >= 4:
            return 2
        z = np.array([0.0, 0.0, 1.0])
        norm = None
        for a, b in self:
            vec = np.abs(b.get_coordinates() - a.get_coordinates())
            vec3 = np.zeros(3)
            vec3[:len(vec)] = vec / np.linalg.norm(vec)
            cr = np.abs(np.cross(vec3, z))
            norm = int(np.argmax(cr))
        return norm


class NoSlipWalls:
    """All no-slip walls of a box [lower, upper] (reference NoSlipWalls,
    nswalls.py:5-47), optionally excluding sides."""

    _SIDES2D = ["left", "right", "up", "down"]
    _SIDES3D = ["left", "right", "up", "down", "back", "front"]

    def __init__(self, lower, upper, exclude=()):
        self.lower = list(lower)
        self.upper = list(upper)
        self.dim = len(lower)
        sides = self._SIDES2D if self.dim == 2 else self._SIDES3D
        self.walls = {}
        for num, side in enumerate(sides):
            if side in exclude:
                continue
            wall = Wall(num, self._side_vertices(side), self.dim)
            wall.set_wall_name(side)
            self.walls[side] = wall
        self.static_walls = list(self.walls.keys())
        self.walls_with_velocity = []
        self.normals = {name: w.compute_normal()
                        for name, w in self.walls.items()}

    def _side_vertices(self, side: str):
        """Two vertices spanning the wall segment (z-walls run along x;
        3D walls carry a dummy z=0 third coordinate like the reference,
        nswalls.py:114-166)."""
        ax = SIDE_NORMAL_AXIS[side]
        val = self.upper[ax] if SIDE_IS_MAX[side] else self.lower[ax]
        run = 1 if ax == 0 else 0      # left/right run along y, others x
        ncoord = 3 if self.dim == 3 else 2
        a = [0.0] * ncoord
        b = [0.0] * ncoord
        a[ax] = b[ax] = val
        a[run] = self.lower[run]
        b[run] = self.upper[run]
        return [a, b]

    def __iter__(self):
        return iter(self.walls.values())

    def __len__(self):
        return len(self.walls)

    def get_walls_names(self):
        return list(self.walls.keys())

    def get_wall_by_side_name(self, name: str) -> Wall:
        return self.walls[name]

    def get_static_walls(self):
        return self.static_walls

    def get_walls_with_velocity(self):
        return self.walls_with_velocity

    def set_wall_velocity(self, name: str, vel):
        if name not in self.walls:
            return
        assert len(vel) == self.dim
        self.walls[name].set_wall_velocity(vel)
        self.walls_with_velocity.append(name)
        self.static_walls.remove(name)

    def get_wall_velocity(self, name: str):
        return self.walls[name].get_wall_velocity()

    def get_static_dofs_by_name(self, name: str):
        return self.walls[name].get_static_dofs()

    def get_wall_normal_by_side_name(self, name: str) -> int:
        return self.normals[name]
