"""The measured solver of an immersed-boundary case: the case dict through
`pynama_tpu_torch.run_case.make_problem` (the entry point users run: a
moving body gives `ImmersedBoundaryDynamic`), set up with the mix's
solver options in the configuration's precision; otherwise
`programs/problem.py`'s `Program`.

A replay is the IBM loop's `start_solver` from the start state with the
mix's dt0 and RK tolerances: per accepted step the RK step through
`Problem.rhs`, the KLE solve, the body's correction and the curl, and the
drag and lift every `save-n-steps` / 10 steps. Every `start_solver` starts
the correction CG from a zero flux (`_start_correction`), so every replay
does the same work; a problem class without that reset is refused at
set-up.

The correction CG runs at the port's own tolerance and cap; the mix
states them (`corr_rtol`, `corr_maxiter`), and set-up refuses a port
whose defaults differ, so a change of either is a change of the traffic.
A replay whose corrections left a relative residual above ten times
`corr_rtol` (the constraint under-enforced) answers with fields of NaN,
which fail every limit.

Each replay records its accepted step times (`reference.answer_steps`,
by its final time): the loop corrects once per step, so its fields depend
on the steps, and the reference marches on the answer's own steps.
"""
from __future__ import annotations

import inspect
import sys

import torch

from harness.spec import load_named
from reference import answer_steps

_base = load_named("programs", "problem")

#: the span the traced replay counts its profiled range in: one rhs
#: evaluation, which the IBM loop's stepper makes through `Problem.rhs`
#: (its KLE solve on the engine does not pass through `rhs_local`)
SPANS = {"rhs": {"targets": [
    ("pynama_tpu_torch.cases.problem", "Problem.rhs")]}}


class Program(_base.Program):
    def __init__(self, cell, device):
        from pynama_tpu_torch.run_case import make_problem
        mix = cell.mix
        opts = {k: mix[k] for k in ("solver", "pc", "cg_rtol", "cg_maxiter")
                if k in mix}
        self.cell, self.device = cell, device
        self.problem = p = make_problem(
            cell.case, device=device,
            dtype=getattr(torch, cell.config["precision"]), **opts)
        if not hasattr(p, "_start_correction"):
            raise RuntimeError(
                f"{type(p).__name__} has no _start_correction: its "
                "correction CG would carry its warm start from one replay "
                "to the next, so replays would not repeat the same work")
        p.setUp()
        from pynama_tpu_torch.ibm import interpolation
        port = {"corr_rtol": p._corr_rtol, "corr_maxiter": inspect.signature(
            interpolation.correction_cg).parameters["maxiter"].default}
        stated = {k: mix.get(k) for k in port}
        if stated != port:
            raise RuntimeError(f"the mix's correction CG settings {stated} "
                               f"are not the port's {port}")
        self.coords = p.mesh.coords

    def describe(self) -> str:
        p = self.problem
        return (f"{super().describe()}; {type(p).__name__}, "
                f"{p.body.n_nodes} body points")

    def warm(self):
        """One rhs and one correction at the start state: K1 built or
        loaded, and every shape of a replay touched (a march resets what
        the correction keeps)."""
        p = self.problem
        _, vel = p.rhs(0.0, self.w0, self.v0)
        p._per_step_correction(vel, 0.0)

    def replay(self):
        p, mix = self.problem, self.cell.mix
        p.vort, p.vel = self.w0.clone(), self.v0.clone()
        p.start_time, p.end_time = 0.0, 1e30
        p.max_steps = mix["segment_steps"]
        times = []
        t, steps = p.start_solver(
            dt0=mix["dt0"], atol=mix["rk_atol"], rtol=mix["rk_rtol"],
            post_step=lambda step, t, dt, vort, vel: times.append(t))
        answer_steps.record(times)
        vort = p.vort.double().cpu().numpy()
        vel = p.vel.double().cpu().numpy()
        worst = max(r for _, r in p.corr_log)
        if worst > 10 * mix["corr_rtol"]:
            print(f"replay to t={t}: a correction CG stopped at relative "
                  f"residual {worst:.3e}, over 10 x corr_rtol "
                  f"{mix['corr_rtol']:g}: its answer fails",
                  file=sys.stderr, flush=True)
            vort, vel = vort * float("nan"), vel * float("nan")
        return t, steps, vort, vel

