"""Adaptive embedded Runge-Kutta time integration (eager PyTorch).

Port of pynama_tpu/solver/timestep.py: the Bogacki-Shampine 5(4) 8-stage
pair (PETSc TS 'rk'/'5bs') with a PETSc-'basic'-style step controller (WRMS
error norm, safety 0.9, factor clip [0.1, 10]) and MATCHSTEP final-time
handling. The stage cascade runs eagerly on the device; the accept/reject
controller reads one scalar (the error norm) per attempt on the host.

Left out until the IBM cases are ported: `AdaptiveStepper`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Tableau:
    name: str
    a: np.ndarray       # (s, s)
    b: np.ndarray       # (s,)  high-order weights
    b_emb: np.ndarray   # (s,)  embedded lower-order weights
    c: np.ndarray       # (s,)
    order: int          # order of the propagated solution
    order_emb: int


def _bs5() -> Tableau:
    """Bogacki-Shampine RK5(4)8, the tableau behind PETSc TSRK5BS."""
    a = np.zeros((8, 8))
    a[1, 0] = 1 / 6
    a[2, :2] = [2 / 27, 4 / 27]
    a[3, :3] = [183 / 1372, -162 / 343, 1053 / 1372]
    a[4, :4] = [68 / 297, -4 / 11, 42 / 143, 1960 / 3861]
    a[5, :5] = [597 / 22528, 81 / 352, 63099 / 585728, 58653 / 366080,
                4617 / 20480]
    a[6, :6] = [174197 / 959244, -30942 / 79937, 8152137 / 19744439,
                666106 / 1039181, -29421 / 29068, 482048 / 414219]
    b = np.array([587 / 8064, 0.0, 4440339 / 15491840, 24353 / 124800,
                  387 / 44800, 2152 / 5985, 7267 / 94080, 0.0])
    a[7, :] = b
    b_emb = np.array([2479 / 34992, 0.0, 123 / 416, 612941 / 3411720,
                      43 / 1440, 2272 / 6561, 79937 / 1113912,
                      3293 / 556956])
    c = a.sum(axis=1)
    return Tableau("5bs", a, b, b_emb, c, order=5, order_emb=4)


def _dp5() -> Tableau:
    """Dormand-Prince 5(4) (PETSc '5dp')."""
    a = np.zeros((7, 7))
    a[1, 0] = 1 / 5
    a[2, :2] = [3 / 40, 9 / 40]
    a[3, :3] = [44 / 45, -56 / 15, 32 / 9]
    a[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
    a[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176,
                -5103 / 18656]
    b = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
                  11 / 84, 0.0])
    a[6, :] = b
    b_emb = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                      -92097 / 339200, 187 / 2100, 1 / 40])
    c = a.sum(axis=1)
    return Tableau("5dp", a, b, b_emb, c, order=5, order_emb=4)


_TABLEAUS = {"5bs": _bs5, "5dp": _dp5}
BS5 = _bs5()


def get_tableau(name: str) -> Tableau:
    return _TABLEAUS[name]()


class StepResult(NamedTuple):
    y: torch.Tensor
    enorm: torch.Tensor
    aux: object


def make_step(rhs: Callable, tableau: Tableau, atol: float, rtol: float,
              err_norm: Optional[Callable] = None):
    """Build the single-attempt stepper.

    rhs(t, y, aux) -> (dy/dt, aux). Returns attempt(t, dt, y, aux) ->
    StepResult with the 5th-order update and the WRMS error norm of
    (y5 - y4) against atol + rtol*max(|y|, |y5|). `err_norm(e)` overrides
    the RMS reduction.
    """
    s = len(tableau.c)
    if err_norm is None:
        err_norm = lambda e: torch.sqrt(torch.mean(e * e))

    def attempt(t, dt, y, aux):
        a = tableau.a
        ks = []
        for i in range(s):
            yi = y
            for j in range(i):
                if a[i, j] != 0.0:
                    yi = yi + float(dt * a[i, j]) * ks[j]
            ki, aux = rhs(t + float(tableau.c[i]) * dt, yi, aux)
            ks.append(ki)
        y5 = y
        y4 = y
        for j in range(s):
            if tableau.b[j] != 0.0:
                y5 = y5 + float(dt * tableau.b[j]) * ks[j]
            if tableau.b_emb[j] != 0.0:
                y4 = y4 + float(dt * tableau.b_emb[j]) * ks[j]
        w = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y5))
        e = (y5 - y4) / w
        return StepResult(y=y5, enorm=err_norm(e), aux=aux)

    return attempt


def adaptive_loop(attempt: Callable, t0: float, t_end: float, y0, aux0,
                  dt0: float, max_steps: int, order: int,
                  safety: float = 0.9, clip: tuple = (0.1, 10.0),
                  dt_min: float = 1e-14,
                  post_step: Optional[Callable] = None,
                  accept_fn: Optional[Callable] = None):
    """Host accept/reject driver over a trial-step function (MATCHSTEP
    semantics — the step controller of PETSc TSAdapt 'basic').

    accept_fn(t, y) -> y transforms every accepted state (pins boundary
    values); post_step(step, t, dt, y, aux) fires per accepted step.
    Returns (t, y, aux, accepted_steps)."""
    expo = -1.0 / order
    t, y, aux, dt = float(t0), y0, aux0, float(dt0)
    step = 0
    while step < max_steps and t < t_end - 1e-14 * max(1.0, abs(t_end)):
        dt = min(dt, t_end - t)
        res = attempt(t, dt, y, aux)
        enorm = float(res.enorm)
        if not np.isfinite(enorm):
            dt *= 0.25
            if dt < dt_min:
                raise RuntimeError("timestep underflow (non-finite error)")
            continue
        factor = safety * (max(enorm, 1e-30)) ** expo
        factor = min(max(factor, clip[0]), clip[1])
        if enorm <= 1.0:
            t += dt
            step += 1
            y, aux = res.y, res.aux
            if accept_fn is not None:
                y = accept_fn(t, y)
            if post_step is not None:
                post_step(step, t, dt, y, aux)
            dt = dt * factor
        else:
            dt = dt * factor
            if dt < dt_min:
                raise RuntimeError("timestep underflow (step rejected)")
    return t, y, aux, step


def adaptive_solve(rhs: Callable, t0: float, t_end: float, y0, aux0,
                   dt0: float = 1e-3, max_steps: int = 10_000,
                   atol: float = 1e-4, rtol: float = 1e-4,
                   tableau: str = "5bs", safety: float = 0.9,
                   clip: tuple = (0.1, 10.0), dt_min: float = 1e-14,
                   post_step: Optional[Callable] = None,
                   accept_fn: Optional[Callable] = None,
                   err_norm: Optional[Callable] = None):
    """Adaptive integration from t0 to t_end (MATCHSTEP semantics).

    post_step(step, t, dt, y, aux) fires on every accepted step;
    accept_fn(t, y) -> y transforms every accepted state.
    Returns (t, y, aux, accepted_steps).
    """
    tab = get_tableau(tableau)
    attempt = make_step(rhs, tab, atol, rtol, err_norm=err_norm)
    return adaptive_loop(attempt, t0, t_end, y0, aux0, dt0, max_steps,
                         order=tab.order, safety=safety, clip=clip,
                         dt_min=dt_min, post_step=post_step,
                         accept_fn=accept_fn)
