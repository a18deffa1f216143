"""The measured solver on a gmsh-file domain: `programs/problem.py`'s
`Program` (the `Problem` class set up from the case dict with the mix's
solver options, in the configuration's precision), with the mesh written
at set-up and the fields in the canonical node order.

The case's domain names its mesh by the numbers of
`meshes/hex_cube.py` (key "hex-cube"); set-up writes that mesh as MSH 2.2
into a temporary directory (under TMPDIR), hands the path to `Problem` as
the domain's `gmsh-file`, and removes the file once the problem is set
up; the writing counts in set-up. The mix's `sumfact` goes to `Problem`
with the other solver options.

The program numbers the nodes its own way (`mesh_from_gmsh`), so `coords`,
the start state `load` takes and the fields `replay` returns are in the
canonical order (`hex_cube.canonical_order`, the order the reference uses
too): `load` maps the start state back to the mesh's order.
"""
from __future__ import annotations

import copy
import os
import tempfile

import numpy as np
import torch

from harness.spec import load_named
from meshes import hex_cube

_base = load_named("programs", "problem")

#: the span the traced replay counts its profiled range in: one rhs
#: evaluation of the element-local route
SPANS = {"rhs": {"targets": [
    ("pynama_tpu_torch.cases.problem", "rhs_local")]}}


class Program(_base.Program):
    def __init__(self, cell, device):
        from pynama_tpu_torch.cases import Problem
        mix = cell.mix
        opts = {k: mix[k] for k in ("solver", "pc", "cg_rtol", "cg_maxiter",
                                    "sumfact") if k in mix}
        case = copy.deepcopy(cell.case)
        hc = case["domain"].pop("hex-cube")
        self.cell, self.device = cell, device
        with tempfile.TemporaryDirectory(prefix="hex_cube-") as tmp:
            case["domain"]["gmsh-file"] = hex_cube.write_msh(
                os.path.join(tmp, "hex_cube.msh"), hc["nelem"],
                float(hc["distort"]), int(hc.get("rng", 0)))
            self.problem = p = Problem(
                case, device=device,
                dtype=getattr(torch, cell.config["precision"]), **opts)
            p.setUp()
        self.order = hex_cube.canonical_order(p.mesh.coords)
        self.unorder = np.argsort(self.order)
        self.coords = np.asarray(p.mesh.coords)[self.order]

    def load(self, vort0, vel0):
        super().load(np.asarray(vort0)[self.unorder],
                     np.asarray(vel0)[self.unorder])

    def replay(self):
        t, steps, vort, vel = super().replay()
        return t, steps, vort[self.order], vel[self.order]
