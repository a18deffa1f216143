"""Whether what the timed path produced is right: each answer against the
plain reference, marched in float64 from the same start state.

An answer is one replay of the cell's segment: (t, steps, vorticity,
velocity), the solver's global fields at the segment's end. The reference
the configuration names (`reference/<name>.py`, float64, TF32 off, its
KLE solves exact or to CG rtol 1e-11) marches from the same start state
(the configuration's start builder on the reference's own nodes) to the
answer's own final time t with its own step controller, and the numbers
compared are the relative L2 gaps of the two fields:

    vort_rel = ||w - w_ref|| / ||w_ref||      vel_rel = likewise for v

Every answer is judged. One reference march serves every answer that
ends at the same t (every replay of a deterministic program does); each
other final time gets a march of its own. An answer that stopped short
of the segment's steps never came and fails.

`readings` gives the numbers seed by seed, for the program (one replay
per seed) or for the control (the reference in the program's place, one
rank of precision lower): the readings the limits are set from, and the
control's failing, go through `judge` like every run.
"""
from __future__ import annotations

import time

import numpy as np
import torch

NUMBERS = ("vort_rel", "vel_rel")


def reference_case(cell, device, control=False):
    """The float64 judge, or with control=True the lower-precision control
    in the program's place: float32, TF32 products, the mix's own CG
    tolerance and cap."""
    Case = cell.piece("reference").Case
    if not control:
        return Case(cell.case, device=device)
    return Case(cell.case, device=device, dtype=torch.float32, tf32=True,
                cg_rtol=cell.mix.get("cg_rtol", 1e-6),
                cg_maxiter=cell.mix.get("cg_maxiter", 1000))


def start_state(cell, coords, seed):
    """The seed's start state (vorticity, velocity) at `coords`, float64."""
    return cell.piece("start").build(cell.case, coords, cell.mix, seed)


def march_segment(ref, cell, seed, t_end=None):
    """The reference's march of the segment from the seed's start state:
    to `t_end` (MATCHSTEP), or for the segment's steps when t_end is
    None. Returns (t, steps, vort, vel) as float64 host arrays."""
    mix = cell.mix
    w0, v0 = (torch.as_tensor(x, device=ref.device, dtype=ref.dtype)
              for x in start_state(cell, ref.coords, seed))
    steps = mix["segment_steps"]
    t, w, v, n = ref.march(w0, v0, 1e30 if t_end is None else t_end,
                           mix["dt0"], mix["rk_atol"], mix["rk_rtol"],
                           max_steps=steps if t_end is None else 100 * steps)
    return t, n, w.double().cpu().numpy(), v.double().cpu().numpy()


def rel_gap(a, b):
    """||a - b|| / ||b||, the relative L2 gap of two fields."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def judge(cell, answers, seed, device, log=print) -> dict:
    """{'numbers': {name: worst reading}, 'compared', 'failed',
    'reference_s'} for `answers` [(t, steps, vort, vel)], every one of
    them judged."""
    t0 = time.perf_counter()
    want = cell.mix["segment_steps"]
    failed = sum(1 for a in answers if a[1] != want)
    done = [a for a in answers if a[1] == want]
    times = list(dict.fromkeys(a[0] for a in done))
    ref = reference_case(cell, device) if times else None
    worst = {k: 0.0 for k in NUMBERS}
    compared = 0
    for t in times:
        _, _, wr, vr = march_segment(ref, cell, seed, t_end=t)
        for a in done:
            if a[0] != t:
                continue
            compared += 1
            bad = False
            for k, got, exact in (("vort_rel", a[2], wr),
                                  ("vel_rel", a[3], vr)):
                r = rel_gap(got, exact)
                r = r if np.isfinite(r) else float("inf")
                worst[k] = max(worst[k], r)
                bad |= not r <= cell.limits[k]
            failed += bad
    log(f"reference: {len(times)} march(es), {compared} answer(s) "
        f"compared, {failed} failed, CG iterations "
        f"{sum(ref.cg_iters) if ref else 0}")
    return {"numbers": worst, "compared": compared, "failed": failed,
            "reference_s": time.perf_counter() - t0}


def answers(cell, seeds, device, control=False) -> dict:
    """{seed: answer} of one replay per seed on the timed path (the
    program set up once for all of them, then freed), or with
    control=True of the control's march; a control that fails to march
    gives its error in place of an answer."""
    out = {}
    if control:
        for seed in seeds:
            try:
                out[seed] = march_segment(
                    reference_case(cell, device, control=True), cell, seed)
            except RuntimeError as e:
                out[seed] = e
        return out
    prog = cell.piece("program").Program(cell, device)
    for seed in seeds:
        prog.load(*start_state(cell, prog.coords, seed))
        out[seed] = prog.replay()
    del prog
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def readings(cell, seeds, device, control=False, log=print) -> list:
    """[(seed, answer, verdict)]: each seed's answer (`answers`) through
    `judge`; a control that gave no answer has failed."""
    rows = []
    for seed, ans in answers(cell, seeds, device, control).items():
        if isinstance(ans, Exception):
            log(f"seed {seed}: no answer ({ans})")
            rows.append((seed, ans, {
                "numbers": {k: float("inf") for k in NUMBERS},
                "compared": 0, "failed": 1, "reference_s": 0.0}))
        else:
            rows.append((seed, ans, judge(cell, [ans], seed, device, log)))
    return rows
