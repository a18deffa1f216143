"""Boundary-condition parsing, dof masks, and value application.

Carried over from pynama_tpu/bc/conditions.py: classifies the problem as
FS / NS / FS-NS and derives the dof masks the KLE solve consumes. Sides
carry constant values or an analytic-function library (`custom-func`,
`functions/`). The engine writes the values on the device in the local
layout (engine/local_engine.py); `apply_velocity` and friends write them
into global-layout fields, numpy arrays or tensors.

The no-slip corner rule reproduces the reference: where a node would have
both an x-normal (left/right) and a y-normal (down/up), the x-normal is
dropped (the x component stays tangential).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from pynama_tpu_torch.functions import get_function_lib
from pynama_tpu_torch.mesh.box import SIDE_NORMAL_AXIS, border_names


@dataclasses.dataclass
class SideBC:
    name: str
    kind: str                      # 'free-slip' | 'no-slip'
    nodes: np.ndarray              # (n_side,) int32
    velocity: Optional[np.ndarray] = None     # (dim,)
    vorticity: Optional[np.ndarray] = None    # (dim_w,)
    func: Optional[object] = None             # analytic function module
    coords: Optional[np.ndarray] = None       # (n_side, dim), for func sides
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

    def values(self, attr: str, t, nu):
        """Boundary field values for 'velocity'/'vorticity', (n_side, c): a
        CPU float64 tensor for a function side, numpy for a constant one."""
        if self.func is not None:
            a = self.func.alpha(nu, t)
            return getattr(self.func, attr)(self.coords, a)
        val = self.velocity if attr == "velocity" else self.vorticity
        if val is None:
            raise ValueError(f"{attr} not set on boundary {self.name}")
        return np.tile(np.asarray(val, dtype=np.float64),
                       (len(self.nodes), 1))


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
            self.bc_type = "FS"
            fn = data["custom-func"]["name"]
            for name in names:
                self._add_func_side(name, fn)
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
                self._add_func_side(name, vals["custom-func"]["name"],
                                    kind=kind)
            else:
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

    def _add_func_side(self, name, func_name, kind="free-slip"):
        nodes = self.mesh.border_nodes(name)
        side = SideBC(name=name, kind=kind, nodes=nodes,
                      func=get_function_lib(func_name),
                      coords=self.mesh.coords[nodes],
                      _normal_axis=self._mesh_normal_axis(name))
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

    # ------------------------------------------------------------ application
    def apply_velocity(self, vel, t=0.0, nu=1.0):
        """Set velocity values on every boundary's nodes, all components,
        sides in order (setValuesToVec). `vel` is an (n_nodes, dim) numpy
        array or tensor; the result is a new one of the same kind."""
        for s in self.sides:
            vel = _set_rows(vel, s.nodes, s.values("velocity", t, nu))
        return vel

    def apply_vorticity(self, vort, t=0.0, nu=1.0):
        for s in self.sides:
            vort = _set_rows(vort, s.nodes, s.values("vorticity", t, nu))
        return vort

    def apply_tangential(self, vel, t=0.0, nu=1.0):
        """Impose tangential velocity on no-slip walls after the FS-stage
        solve (setTangentialValuesToVec)."""
        for s in self.sides:
            if s.kind != "no-slip":
                continue
            vals = s.values("velocity", t, nu)
            for d in range(self.dim):
                if d != s.normal_axis:
                    vel = _set_rows(vel, s.nodes, vals[:, d], col=d)
        return vel


def _set_rows(arr, nodes, vals, col=None):
    """A copy of `arr` with rows `nodes` (all columns, or column `col`) set
    to `vals`; numpy in, numpy out; a tensor in, a tensor on its device."""
    if isinstance(arr, torch.Tensor):
        out = arr.clone()
        idx = torch.as_tensor(nodes, dtype=torch.int64, device=arr.device)
        v = torch.as_tensor(vals).to(dtype=arr.dtype, device=arr.device)
        if col is None:
            out[idx] = v.reshape(len(nodes), -1)
        else:
            out[idx, col] = v
        return out
    out = np.array(arr)
    v = np.asarray(vals)
    if col is None:
        out[nodes, :] = v.reshape(len(nodes), -1)
    else:
        out[nodes, col] = v
    return out
