"""The plain reference of a body in prescribed motion in a uniform stream,
in PyTorch on the global node layout: the upstream's dynamic immersed
boundary loop (Pynama `src/cases/immersed_boundary.py:56-113` and
`:286-385`, kinematics `src/domain/immersed_body.py:266-282`), restated.

The flow is `reference.cavity.Case` (its set-up from `reference.setup`,
its operators, KLE solve, Bogacki-Shampine 5(4) pair, step controller and
MATCHSTEP) on the case's box, with the `uniform` block read as the
measured solver reads it: a `free-slip` block of the constant velocity
U (cos a, sin a) on all four sides, U = re mu / (rho Lref) and a the
block's `direction` in degrees, vorticity 0 there. The body is one
circle of radius r about `center`:

- L = ceil(2 pi r / h) points at the angles pi/1000 + 2 pi k / L, each
  of measure dl = 2 pi r / L; h is the node separation along x, (upper -
  lower) / nelem / (ngl - 1);
- at time t its centre is `center` + (0, A sin(2 pi t / Te)) and every
  point moves with (0, 2 pi A cos(2 pi t / Te) / Te), A = 0.3, Te = 5 / U;
- the interpolation W (L x n nodes, dense) is the fourGrid delta of
  Peskin in index space: per axis the fractional node index eta(X), the
  piecewise-linear inverse of the axis coordinates, and the weight
  phi(|i - eta|) of every node index i; a node's weight is the product
  of its two axes' weights.

The correction at time t solves C z = v_body - W v with C = W W^T dl h
by a Cholesky factor of C (in the case's dtype: float64 for the judge),
then v += W^T z dl h. The loop: at t = 0 the KLE solve from the start
state, the correction at the body's t = 0, vorticity = curl(v); then per
accepted step of the pair (from the last corrected velocity) the KLE
solve at the step's end state, the correction at the step's t and
vorticity = curl(v). `march` returns the last corrected fields.

The steps: the loop corrects once per accepted step, so its fields
depend on the steps at O(dt), and a float32 program's controller, whose
error norm carries the error of its float32 KLE solves, takes other
steps than this reference's. Where the program recorded the answer's accepted step times
(`reference.answer_steps`, by final time), `march` takes those steps
and holds each to its own error test: a step whose float64 error norm
is over STEP_TEST, one this reference's controller would reject, gives
fields of NaN, which fail every limit. STEP_TEST is 1.01, not 1: a
float32 controller's norm of an accepted step lies within 1e-3 of the
float64 norm of that step (CPU, 30^2 ngl=3, 3 seeds x 10 steps), so a
step it accepted at 0.999 is no fault; a controller fault that takes
steps twice too long reads ~2^5 = 32. Otherwise it steps with its own
controller and records its steps the same way, so the control, marched
in the program's place, is judged on its own steps too.

Departures from the upstream, each the measured solver's too:
- the delta's argument is the index distance |i - eta|, where the
  upstream takes the physical distance over h; on a box at ngl=3 the
  nodes are equally spaced, so the two agree to rounding;
- C z = rhs is solved directly, where the upstream rebuilds its PETSc
  matrices and solves by a Krylov method every step;
- the march starts from the benchmark's seeded start state, not from
  the file's vorticity 0, and stops at the answer's time, on the
  answer's steps where they were recorded;
- no forces are computed: the answers compared are the fields.

`tf32=True` rounds W and the velocity to TF32 before each product, as
`reference.cavity` does for its operators: the lower-precision control.
Imports nothing of the measured package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import answer_steps, cavity
from reference.cavity import _A, _B, _BE, _C, ORDER, round_tf32

SIDES = ("left", "right", "down", "up")
AMPLITUDE = 0.3          # the oscillation's amplitude
PERIODS = 5.0            # Te = PERIODS / U
STEP_TEST = 1.01         # the largest error norm of a step marched on


def uniform_velocity(block: dict) -> np.ndarray:
    """[U cos a, U sin a] of a `uniform` block given by its Reynolds
    number (re, mu, rho, Lref, direction in degrees)."""
    u = block["re"] * block["mu"] / (block["rho"] * float(block["Lref"]))
    a = math.radians(block["direction"])
    return np.array([u * math.cos(a), u * math.sin(a)])


def four_grid(r: np.ndarray) -> np.ndarray:
    """Peskin's four-point delta at |distance| r in grid units."""
    r = np.abs(r)
    inner = (3 - 2 * r + np.sqrt(np.clip(1 + 4 * r - 4 * r * r, 0, None)))
    outer = (5 - 2 * r - np.sqrt(np.clip(-7 + 12 * r - 4 * r * r, 0, None)))
    return np.where(r <= 1, inner, np.where(r <= 2, outer, 0.0)) / 8


class Case(cavity.Case):
    """One moving circle in the case's uniform stream: the flow of
    `reference.cavity.Case`, the body, its correction and the loop."""

    def __init__(self, config: dict, *, device, dtype=torch.float64,
                 tf32=False, cg_rtol=1e-11, cg_maxiter=50000):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        bc = config["boundary-conditions"]
        if set(bc) != {"uniform"}:
            raise ValueError(f"expected a uniform block, got {sorted(bc)}")
        self.u_inf = uniform_velocity(bc["uniform"])
        flow = dict(config, **{"boundary-conditions": {"free-slip": {
            s: list(self.u_inf) for s in SIDES}}})
        super().__init__(flow, device=device, dtype=dtype, tf32=tf32,
                         cg_rtol=cg_rtol, cg_maxiter=cg_maxiter)
        bodies = config["bodies"]
        if self.dim != 2 or len(bodies) != 1 \
                or bodies[0]["type"] != "circle" \
                or bodies[0].get("vel") != "dynamic":
            raise ValueError("expected one moving circle in 2D")
        body = bodies[0]
        box = self.box
        self.h = (box.upper[0] - box.lower[0]) / box.nelem[0] \
            / (box.ngl - 1)
        r = float(body.get("radius", 0.5))
        self.L = math.ceil(2 * math.pi * r / self.h)
        self.dl = 2 * math.pi * r / self.L
        ang = math.pi / 1000 + 2 * math.pi * np.arange(self.L) / self.L
        self.ring = r * np.stack([np.cos(ang), np.sin(ang)], axis=1)
        self.center = np.asarray(body.get("center", (0, 0)), float)
        self.period = PERIODS / float(np.linalg.norm(self.u_inf))
        self.axes = [box.axis_coords(d) for d in range(2)]

    # ------------------------------------------------------------------ body
    def body(self, t):
        """(points (L, 2), their velocity (L, 2)) at time t, float64."""
        w = 2 * math.pi / self.period
        c = self.center + np.array([0.0, AMPLITUDE * math.sin(w * t)])
        v = np.array([0.0, AMPLITUDE * w * math.cos(w * t)])
        return c + self.ring, np.tile(v, (self.L, 1))

    def interpolation(self, points):
        """W (L, n): each point's delta weights on every node."""
        ws = []
        for d, axis in enumerate(self.axes):
            eta = np.interp(points[:, d], axis, np.arange(axis.size))
            ws.append(four_grid(np.arange(axis.size)[None, :]
                                - eta[:, None]))
        W = (ws[0][:, :, None] * ws[1][:, None, :]).reshape(self.L, -1)
        return torch.as_tensor(W, device=self.device, dtype=self.dtype)

    def correct(self, vel, t):
        """vel + W^T z dl h with C z = v_body - W vel, C = W W^T dl h."""
        points, vb = self.body(t)
        W = self.interpolation(points)
        if self.tf32:
            W = round_tf32(W)
        v = round_tf32(vel) if self.tf32 else vel
        scale = self.dl * self.h
        factor = torch.linalg.cholesky((W @ W.T) * scale)
        rhs = torch.as_tensor(vb, device=self.device, dtype=self.dtype) \
            - W @ v
        z = torch.cholesky_solve(rhs, factor)
        return vel + (W.T @ z) * scale

    def _settle(self, vort, vel, t):
        """The loop's KLE solve, correction and curl at time t."""
        _, vel = self.solve_kle(vort, vel)
        vel = self.correct(vel, t)
        return self.curl(vel), vel

    # ------------------------------------------------------------------ march
    def _attempt(self, t, dt, vort, vel):
        """One attempt of the pair from (vort, vel): (y5, the last stage's
        velocity, the error norm)."""
        ks, aux = [], vel
        for i in range(8):
            yi = vort
            for j in range(i):
                if _A[i, j] != 0.0:
                    yi = yi + float(dt * _A[i, j]) * ks[j]
            k, aux = self.rhs(t + float(_C[i]) * dt, yi, aux)
            ks.append(k)
        y5, y4 = vort, vort
        for j in range(8):
            if _B[j] != 0.0:
                y5 = y5 + float(dt * _B[j]) * ks[j]
            if _BE[j] != 0.0:
                y4 = y4 + float(dt * _BE[j]) * ks[j]
        w = self.atol + self.rtol * torch.maximum(vort.abs(), y5.abs())
        return y5, aux, float(torch.sqrt(torch.mean(((y5 - y4) / w) ** 2)))

    def march(self, vort, vel, t_end, dt0, atol, rtol, max_steps=100_000,
              safety=0.9, clip=(0.1, 10.0), dt_min=1e-14):
        """The loop from t = 0 to t_end (MATCHSTEP): (t, vort, vel,
        accepted steps), the fields as the last correction left them; on
        the steps recorded for t_end where there are any."""
        self.atol, self.rtol = atol, rtol
        vort, vel = self._settle(vort, vel, 0.0)
        times = answer_steps.of(t_end)
        if times is not None:
            return self._follow(vort, vel, times)
        t, dt, done = 0.0, float(dt0), []
        while len(done) < max_steps \
                and t < t_end - 1e-14 * max(1.0, abs(t_end)):
            h = min(dt, t_end - t)
            y5, aux, enorm = self._attempt(t, h, vort, vel)
            if not np.isfinite(enorm):
                dt = h * 0.25
                if dt < dt_min:
                    raise RuntimeError("reference: dt underflow")
                continue
            dt = h * min(max(safety * max(enorm, 1e-30) ** (-1.0 / ORDER),
                             clip[0]), clip[1])
            if enorm <= 1.0:
                t += h
                done.append(t)
                vort, vel = self._settle(y5, aux, t)
            elif dt < dt_min:
                raise RuntimeError("reference: dt underflow")
        answer_steps.record(done)
        return t, vort, vel, len(done)

    def _follow(self, vort, vel, times):
        """The loop on the given accepted step times from the settled
        start; NaN fields from the first step that fails the error test."""
        t = 0.0
        for n, t_next in enumerate(times):
            y5, aux, enorm = self._attempt(t, t_next - t, vort, vel)
            if not enorm <= STEP_TEST:
                nan = float("nan")
                return t_next, vort * nan, vel * nan, n + 1
            t = t_next
            vort, vel = self._settle(y5, aux, t)
        return t, vort, vel, len(times)
