"""The measured solver as a configuration of the `Problem` class runs it:
`pynama_tpu_torch.cases.Problem` set up from the case dict with the mix's
solver options, in the configuration's precision.

`Program(cell, device)` sets the problem up; `load(vort0, vel0)` takes the
start state (host float64 arrays on `coords`); `warm()` evaluates one rhs
there, which builds or loads K1 and touches every shape the segment uses;
`replay()` marches the segment (the mix's `segment_steps` accepted steps,
`Problem.start_solver` with its dt0 and RK tolerances) from the start
state and returns the answer (t, steps, vorticity, velocity), the global
fields float64 on the host.
"""
from __future__ import annotations

import torch

#: the span the traced replay counts its profiled range in: one rhs
#: evaluation, on the element-local route or the global (direct) one
SPANS = {"rhs": {"targets": [
    ("pynama_tpu_torch.cases.problem", "rhs_local"),
    ("pynama_tpu_torch.cases.problem", "Problem.rhs")]}}


class Program:
    def __init__(self, cell, device):
        from pynama_tpu_torch.cases import Problem
        mix = cell.mix
        opts = {k: mix[k] for k in ("solver", "pc", "cg_rtol", "cg_maxiter")
                if k in mix}
        self.cell, self.device = cell, device
        self.problem = p = Problem(
            cell.case, device=device,
            dtype=getattr(torch, cell.config["precision"]), **opts)
        p.setUp()
        self.coords = p.mesh.coords

    def describe(self) -> str:
        p = self.problem
        phases = {k: round(v, 3) for k, v in p.setup_phases.items()}
        return (f"{p.mesh.n_nodes} nodes, solver {p.solver_method}, dtype "
                f"{p.dtype}; setUp phases {phases}")

    def load(self, vort0, vel0):
        kw = dict(dtype=self.problem.dtype, device=self.device)
        self.w0 = torch.as_tensor(vort0, **kw)
        self.v0 = torch.as_tensor(vel0, **kw)

    def warm(self):
        p = self.problem
        if p.engine_ops is not None:
            from pynama_tpu_torch.engine.local_engine import rhs_local
            rhs_local(p.engine_ops, 0.0, p.to_local(self.w0),
                      p.to_local(self.v0))
        else:
            p.rhs(0.0, self.w0, self.v0)

    def replay(self):
        p, mix = self.problem, self.cell.mix
        p.vort, p.vel = self.w0.clone(), self.v0.clone()
        p.start_time, p.end_time = 0.0, 1e30
        p.max_steps = mix["segment_steps"]
        t, steps = p.start_solver(dt0=mix["dt0"], atol=mix["rk_atol"],
                                  rtol=mix["rk_rtol"])
        return (t, steps, p.vort.double().cpu().numpy(),
                p.vel.double().cpu().numpy())
