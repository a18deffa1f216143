"""Immersed (Lagrangian) bodies: shapes, regularized diracs, kinematics.

Port of pynama_tpu/ibm/bodies.py (reference `src/domain/immersed_body.py`):
body point clouds with uniform arclength spacing dl, the three
regularized-delta kernels (`immersed_body.py:398-421`), prescribed
sinusoidal motion for the dynamic case (`immersed_body.py:266-282`), and
force integration from the virtual flux (`immersed_body.py:117-130`).

The kernels are functions on tensors (the support tables evaluate them on
the device); coordinates and kinematics are host numpy, as in the JAX
package.
"""
from __future__ import annotations

from math import ceil, pi, sqrt

import numpy as np
import torch


# ------------------------------------------------------------ dirac kernels
def linear(r: torch.Tensor) -> torch.Tensor:
    """1-cell hat kernel (`immersed_body.py:405-410`)."""
    return torch.where(r < 1.0, 1.0 - r, torch.zeros_like(r))


def three_grid(r: torch.Tensor) -> torch.Tensor:
    """3-cell kernel (`immersed_body.py:398-404`)."""
    r2 = r * r
    inner = (1.0 + torch.sqrt(torch.clamp(-3.0 * r2 + 1.0, min=0.0))) / 3.0
    mid = (5.0 - 3.0 * r
           - torch.sqrt(torch.clamp(-3.0 * (1.0 - r) ** 2 + 1.0,
                                    min=0.0))) / 6.0
    return torch.where(r <= 0.5, inner,
                       torch.where(r <= 1.5, mid, torch.zeros_like(r)))


def four_grid(r: torch.Tensor) -> torch.Tensor:
    """4-cell kernel, the production default (`immersed_body.py:413-421`,
    default at `immersed_body.py:136`)."""
    inner = (3.0 - 2.0 * r
             + torch.sqrt(torch.clamp(1.0 + 4.0 * r - 4.0 * r * r,
                                      min=0.0))) / 8.0
    outer = (5.0 - 2.0 * r
             - torch.sqrt(torch.clamp(-7.0 + 12.0 * r - 4.0 * r * r,
                                      min=0.0))) / 8.0
    return torch.where(r <= 1.0, inner,
                       torch.where(r <= 2.0, outer, torch.zeros_like(r)))


KERNELS = {"linear": linear, "threeGrid": three_grid, "fourGrid": four_grid}
#: half-width of each kernel's support in grid spacings
KERNEL_SUPPORT = {"linear": 1.0, "threeGrid": 1.5, "fourGrid": 2.0}


# ------------------------------------------------------------------- shapes
class ImmersedBody:
    """One rigid body: local point cloud + rigid-motion state."""

    kernel = "fourGrid"
    dim = 2

    def __init__(self, vel=(0.0, 0.0), center=(0.0, 0.0)):
        self.start_center = np.asarray(center, dtype=np.float64)
        self.center = self.start_center.copy()
        self.vel = np.asarray(vel, dtype=np.float64)
        self.is_moving = False
        self.dl = None
        self.local_coords = None   # (L, 2) body-frame coordinates
        self.vel_ref = 1.0

    # shape interface ------------------------------------------------------
    def generate(self, dh: float):
        raise NotImplementedError

    def create(self, dh: float):
        self.local_coords, self.dl = self.generate(dh)

    @property
    def n_nodes(self) -> int:
        return len(self.local_coords)

    def coordinates(self) -> np.ndarray:
        """(L, 2) current world coordinates."""
        return self.local_coords + self.center[None, :]

    def velocities(self) -> np.ndarray:
        """(L, 2) rigid velocity at each body node."""
        return np.tile(self.vel, (self.n_nodes, 1))

    # kinematics -----------------------------------------------------------
    def update_parameters(self, t: float):
        """Prescribed transverse oscillation (reference
        updateBodyParameters, `immersed_body.py:266-282`): A=0.3, f=5,
        Te=f/Uref, y(t) = A sin(2 pi t / Te)."""
        if not self.is_moving:
            return
        f = 5.0
        Te = f / self.vel_ref
        A = 0.3
        self.center = np.array([
            self.start_center[0],
            A * np.sin(2 * pi * t / Te) + self.start_center[1]])
        self.vel = np.array([0.0, 2 * pi * A * np.cos(2 * pi * t / Te) / Te])

    # forces ---------------------------------------------------------------
    def compute_force(self, flux: np.ndarray):
        """Sum of virtual-flux components (reference computeForce via
        `immersed_body.py:117-130`)."""
        flux = np.asarray(flux).reshape(-1, self.dim)
        return tuple(float(flux[:, d].sum()) for d in range(self.dim))


class Circle(ImmersedBody):
    def __init__(self, vel=(0, 0), center=(0, 0), radius=0.5):
        super().__init__(vel, center)
        self.radius = float(radius)

    def generate(self, dh):
        """Uniform points on the circumference (`immersed_body.py:371-390`:
        points = ceil(2 pi r / dh), start angle pi/1000)."""
        r = self.radius
        points = ceil(2 * pi * r / dh)
        start = pi / 1000
        ang = np.linspace(0, 2 * pi, points, endpoint=False) + start
        coords = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
        dl = 2 * pi * r / points
        return coords, dl


class Line(ImmersedBody):
    def __init__(self, vel=(0, 0), center=(0, 0), longitud=2.0):
        super().__init__(vel, center)
        self.longitud = float(longitud)

    def generate(self, dl):
        """(`immersed_body.py:293-308`)"""
        div = ceil(self.longitud / dl)
        x = np.linspace(0, self.longitud, div)
        coords = np.stack([x, np.zeros(div)], axis=1)
        return coords, dl


class OpenBox(ImmersedBody):
    """Diamond-oriented box outline (`immersed_body.py:315-345`)."""

    def __init__(self, vel=(0, 0), center=(0, 0), longitud=1.0):
        super().__init__(vel, center)
        self.longitud = float(longitud)

    def generate(self, dl):
        lng = self.longitud
        div = ceil(sqrt(2.0) / dl)
        verts = [(0, lng), (-lng, 0), (0, -lng), (lng, 0), (0, lng)]
        xs, ys = [], []
        for (x0, y0), (x1, y1) in zip(verts[:-1], verts[1:]):
            xs.append(np.linspace(x0, x1, div, endpoint=False))
            ys.append(np.linspace(y0, y1, div, endpoint=False))
        coords = np.stack([np.concatenate(xs), np.concatenate(ys)], axis=1)
        return coords, dl


class Sphere(ImmersedBody):
    """3D sphere shell: near-uniform Lagrangian points via a Fibonacci
    lattice; dl is the area per point (the 3D analog of the arclength
    spacing the 2D shapes carry)."""

    dim = 3

    def __init__(self, vel=(0, 0, 0), center=(0, 0, 0), radius=0.5):
        super().__init__(vel, center)
        self.radius = float(radius)

    def generate(self, dh):
        r = self.radius
        area = 4.0 * pi * r * r
        points = max(int(ceil(area / (dh * dh))), 12)
        i = np.arange(points)
        golden = pi * (3.0 - sqrt(5.0))
        z = 1.0 - 2.0 * (i + 0.5) / points
        rho = np.sqrt(np.maximum(1.0 - z * z, 0.0))
        theta = golden * i
        coords = r * np.stack([rho * np.cos(theta), rho * np.sin(theta), z],
                              axis=1)
        dl = area / points        # area measure per Lagrangian point
        return coords, dl


class BodiesContainer:
    """All bodies of a case (reference BodiesContainer,
    `immersed_body.py:8-130`)."""

    @property
    def ref_length(self) -> float:
        """Characteristic length for force coefficients: the first body's
        diameter (circle/sphere) or longitude, else 1 (the reference
        normalizes by 0.5*U^2 only, immersed_boundary.py:115-120)."""
        b = self.bodies[0]
        if hasattr(b, "radius"):
            # mirrors the JAX package, a known fault of it: for a sphere
            # the frontal area (pi r^2) belongs here, not the diameter
            return 2.0 * b.radius
        if hasattr(b, "longitud"):
            return float(b.longitud)
        return 1.0

    TYPES = {"circle": Circle, "line": Line, "box": OpenBox,
             "sphere": Sphere}

    def __init__(self, bodies_cfg: list, dim: int = 2):
        self.dim = dim
        self.bodies: list[ImmersedBody] = []
        for cfg in bodies_cfg:
            kind = cfg["type"]
            if kind not in self.TYPES:
                raise ValueError(f"body type '{kind}' not defined")
            kw = dict(center=cfg.get("center", (0,) * dim))
            if kind in ("circle", "sphere"):
                kw["radius"] = cfg.get("radius", 0.5)
                if dim == 3 and kind == "circle":
                    raise ValueError("use body type 'sphere' in 3D")
            if kind == "sphere":
                kw.setdefault("vel", (0, 0, 0))
            body = self.TYPES[kind](**kw)
            body.dim = dim
            if cfg.get("vel") == "dynamic":
                body.is_moving = True
            self.bodies.append(body)

    def create_bodies(self, dh: float):
        for b in self.bodies:
            b.create(dh)

    @property
    def is_moving(self) -> bool:
        return any(b.is_moving for b in self.bodies)

    @property
    def n_nodes(self) -> int:
        return sum(b.n_nodes for b in self.bodies)

    @property
    def dl(self) -> float:
        return self.bodies[0].dl

    def set_vel_ref(self, u):
        for b in self.bodies:
            b.vel_ref = u

    def coordinates(self) -> np.ndarray:
        return np.concatenate([b.coordinates() for b in self.bodies])

    def velocities(self) -> np.ndarray:
        return np.concatenate([b.velocities() for b in self.bodies])

    def update_parameters(self, t: float):
        for b in self.bodies:
            b.update_parameters(t)

    def compute_force(self, flux: np.ndarray, scale: float):
        """Per-body (fx, fy) lists, each divided by `scale` (reference
        BodiesContainer.computeForce, `immersed_body.py:93-104`)."""
        fx, fy = [], []
        off = 0
        flux = np.asarray(flux).reshape(-1, self.dim)
        for b in self.bodies:
            f = flux[off:off + b.n_nodes]
            fx.append(float(f[:, 0].sum() / scale))
            fy.append(float(f[:, 1].sum() / scale))
            off += b.n_nodes
        return fx, fy
