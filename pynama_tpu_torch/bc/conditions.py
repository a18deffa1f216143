"""Boundary-condition parsing and free/constrained dof masks (host numpy).

Carried over from pynama_tpu/bc/conditions.py: classifies the problem as
FS / NS / FS-NS and derives the dof masks the KLE solve consumes. The values
are written on the device by the engine's BC writers
(engine/local_engine.py), from constant buffers built here at setup.

Analytic-function sides (`custom-func`) need the `functions/` libraries,
which are not ported yet (ROADMAP Queue A item 5): they raise
NotImplementedError. The global-layout value writers (`apply_velocity`
and friends) are left out with the global-layout path that uses them.

The no-slip corner rule reproduces the reference: where a node would have
both an x-normal (left/right) and a y-normal (down/up), the x-normal is
dropped (the x component stays tangential).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from pynama_tpu_torch.mesh.box import SIDE_NORMAL_AXIS, border_names

_FUNC_TODO = ("analytic-function ('custom-func') boundary sides need the "
              "functions/ libraries, not ported yet (ROADMAP Queue A item 5)")


@dataclasses.dataclass
class SideBC:
    name: str
    kind: str                      # 'free-slip' | 'no-slip'
    nodes: np.ndarray              # (n_side,) int32
    velocity: Optional[np.ndarray] = None     # (dim,)
    vorticity: Optional[np.ndarray] = None    # (dim_w,)
    #: outward-normal axis (mesh-provided)
    _normal_axis: Optional[int] = None

    @property
    def normal_axis(self) -> int:
        if self._normal_axis is not None:
            return self._normal_axis
        if self.name in SIDE_NORMAL_AXIS:
            return SIDE_NORMAL_AXIS[self.name]
        raise ValueError(f"boundary '{self.name}' has no axis-aligned "
                         "outward normal")


class BoundaryConditions:
    def __init__(self, mesh, data: dict):
        self.mesh = mesh
        self.dim = mesh.dim
        self.dim_w = mesh.dim_w
        self.sides: list[SideBC] = []
        self.bc_type: Optional[str] = None
        self._parse(data)
        self._build_masks()

    # ------------------------------------------------------------------ parse
    def _parse(self, data):
        names = getattr(self.mesh, "border_name_list",
                        border_names(self.dim))
        if "uniform" in data:
            self.bc_type = "FS"
            vals = self._handle_uniform(data["uniform"])
            for name in names:
                self._add_side(name, "free-slip", vals)
        elif "custom-func" in data:
            raise NotImplementedError(_FUNC_TODO)
        elif "free-slip" in data and "no-slip" in data:
            self.bc_type = "FS-NS"
            self._per_side("free-slip", data["free-slip"])
            self._per_side("no-slip", data["no-slip"])
        elif "free-slip" in data:
            self.bc_type = "FS"
            self._per_side("free-slip", data["free-slip"])
        elif "no-slip" in data:
            self.bc_type = "NS"
            self._per_side("no-slip", data["no-slip"])
        else:
            raise ValueError("Boundary conditions not defined")

    def _per_side(self, kind, sides_dict):
        for name, vals in sides_dict.items():
            if isinstance(vals, dict) and "custom-func" in vals:
                raise NotImplementedError(_FUNC_TODO)
            self._add_side(name, kind, vals)

    def _handle_uniform(self, u: dict) -> dict:
        """Uniform free-slip values, including the Reynolds-number form."""
        if "velocity" in u and "vorticity" not in u:
            return {"velocity": u["velocity"],
                    "vorticity": [0] * self.dim_w}
        if "re" in u:
            for k in ("mu", "rho", "Lref", "direction"):
                if k not in u:
                    raise ValueError("mu, rho, Lref AND/OR direction "
                                     "not defined")
            L = eval(str(u["Lref"]), {"sqrt": math.sqrt, "pi": math.pi})
            vel_ref = u["re"] * (u["mu"] / u["rho"]) / L
            ang = math.radians(u["direction"])
            vel = [math.cos(ang) * vel_ref, math.sin(ang) * vel_ref]
            if self.dim == 3:
                vel.append(0.0)
            return {"velocity": vel, "vorticity": [0] * self.dim_w}
        return dict(u)

    def _mesh_normal_axis(self, name):
        fn = getattr(self.mesh, "border_normal_axis", None)
        return fn(name) if fn is not None else None

    def _add_side(self, name, kind, vals):
        nodes = self.mesh.border_nodes(name)
        side = SideBC(name=name, kind=kind, nodes=nodes,
                      _normal_axis=self._mesh_normal_axis(name))
        if isinstance(vals, (list, tuple, np.ndarray)):
            side.velocity = np.asarray(vals, dtype=np.float64)
            side.vorticity = np.zeros(self.dim_w)
        else:
            for attr, v in vals.items():
                setattr(side, attr, np.asarray(v, dtype=np.float64))
        self.sides.append(side)

    # ------------------------------------------------------------------ masks
    def _build_masks(self):
        n, dim = self.mesh.n_nodes, self.dim
        dirichlet = np.zeros((n, dim), dtype=bool)
        normal = np.zeros((n, dim), dtype=bool)
        tang = np.zeros((n, dim), dtype=bool)
        for s in self.sides:
            if s.kind == "free-slip":
                dirichlet[s.nodes, :] = True
            else:
                ax = s.normal_axis
                normal[s.nodes, ax] = True
                for d in range(dim):
                    if d != ax:
                        tang[s.nodes, d] = True
        # corner rule: x-normal dropped where y-normal present
        if dim >= 2:
            both = normal[:, 0] & normal[:, 1]
            normal[both, 0] = False
        tang &= ~normal
        tang &= ~dirichlet
        normal &= ~dirichlet

        self.dirichlet_mask = dirichlet
        self.ns_normal_mask = normal
        self.ns_tang_mask = tang
        #: main-solve free dofs: everything not on a constrained boundary
        self.free_main = ~(dirichlet | normal | tang)
        #: FS-stage free dofs (NS problems): tangential wall dofs stay free
        self.free_fs = ~(dirichlet | normal)
        #: nodes with any no-slip constraint
        ns_nodes = set()
        dir_nodes = set()
        for s in self.sides:
            (ns_nodes if s.kind == "no-slip" else dir_nodes).update(
                s.nodes.tolist())
        self.noslip_nodes = np.array(sorted(ns_nodes), dtype=np.int32)
        self.dirichlet_nodes = np.array(sorted(dir_nodes), dtype=np.int32)

    @property
    def needs_fs_stage(self) -> bool:
        return self.bc_type in ("NS", "FS-NS")
