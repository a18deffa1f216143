"""The port's moving-cylinder loop against the benchmark's plain reference
of that case (`benchmark/reference/ibm_cylinder.py`), the way the
benchmark's ibm.dynamic cell compares them: the configuration
`ibm-dynamic-100-ngl3` (the upstream ibm-dynamic.yaml) cut to 10^2
elements at ngl=3, the program module `programs/ibm_problem.py`
(`run_case.make_problem` -> ImmersedBoundaryDynamic, the engine's CG, the
moving body's correction CG), three accepted steps of the cell's mix from
a seeded start, the reference marched on the port's accepted steps (which
the program module records for it) to the port's final time.

Tolerances (relative L2 gaps, float64 on the CPU): the reference solves
its KLE systems (882 dofs) and its correction with f64 Cholesky factors,
the port with CG at rtol 1e-12 for both, so the gaps sit near that stop:
1.4e-11 (vorticity, which the correction's spread and the curl make the
rougher field) and 6.3e-12 (velocity) measured; VORT_TOL and VEL_TOL
leave about 30x above those. The same run in float32 (the cell's own
precision, KLE CG rtol 1e-8, correction CG rtol 1e-7) reads 4.7e-6 /
2.5e-6 on its own steps, five orders above them.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import check  # noqa: E402
from harness.spec import Cell  # noqa: E402

torch.set_num_threads(1)

VORT_TOL = 5e-10
VEL_TOL = 2e-10
SEED = 2**31 + 17
STEPS = 3
CONFIG = os.path.join(BENCH, "configs", "ibm-dynamic-100-ngl3.json")
MIX = os.path.join(BENCH, "traffic", "cg-ibm-dynamic-10steps.json")
LIMITS = os.path.join(BENCH, "limits", "ibm.dynamic.json")


def cell(nelem=10, precision="float64", steps=STEPS):
    """The ibm.dynamic cell cut to nelem^2 elements and STEPS steps; in
    float64 the port's KLE CG stops at rtol 1e-12 and its correction CG at
    its float64 default, 1e-12, in float32 at the mix's own 1e-8 and
    1e-7."""
    cfg = json.load(open(CONFIG))
    cfg["case"]["domain"]["box-mesh"]["nelem"] = [nelem] * 2
    cfg["precision"] = precision
    mix = json.load(open(MIX))
    mix["segment_steps"] = steps
    if precision == "float64":
        mix["cg_rtol"] = mix["corr_rtol"] = 1e-12
    return Cell(name="ibm.dynamic", chips=1, config=cfg, mix=mix,
                limits={"vort_rel": VORT_TOL, "vel_rel": VEL_TOL},
                end_to_end=[], per_layer=[], bench_dir=BENCH)


def replays(c, n=1):
    """(the program, the answers of n replays of the segment)."""
    prog = c.piece("program").Program(c, "cpu")
    prog.load(*check.start_state(c, prog.coords, SEED))
    return prog, [prog.replay() for _ in range(n)]


@pytest.fixture(scope="module")
def f64():
    return replays(cell(), 2)


def test_port_matches_the_reference_in_f64(f64):
    prog, answers = f64
    p = prog.problem
    assert type(p).__name__ == "ImmersedBoundaryDynamic"
    assert p.solver_method == "cg" and p.engine_ops is not None
    assert answers[0][1] == STEPS and answers[0][2].shape == (21 ** 2, 1)
    logs = []
    v = check.judge(cell(), answers, SEED, "cpu", log=logs.append)
    assert "1 march(es), 2 answer(s)" in logs[0]
    assert v["compared"] == 2 and v["failed"] == 0, v["numbers"]
    assert v["numbers"]["vort_rel"] <= VORT_TOL
    assert v["numbers"]["vel_rel"] <= VEL_TOL


def test_replays_start_from_the_same_correction_state(f64):
    """Each march starts the correction CG from a zero flux and an empty
    log: two replays give bitwise-equal fields, times and CG counts."""
    prog, (a, b) = f64
    assert a[:2] == b[:2]
    assert np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
    p = prog.problem
    first = list(p.corr_log)
    assert len(first) == STEPS + 1
    flux = p._flux.clone()
    prog.replay()
    assert p.corr_log == first and torch.equal(p._flux, flux)


def test_program_refuses_a_loop_that_keeps_its_warm_start(monkeypatch):
    """An IBM class whose marches do not reset the correction CG's warm
    start (no `_start_correction`) would not repeat the same work replay
    after replay: the program module refuses it before its set-up."""
    from pynama_tpu_torch import run_case

    class Kept:
        def setUp(self):
            raise AssertionError("set up a refused problem")

    monkeypatch.setattr(run_case, "make_problem", lambda *a, **k: Kept())
    c = cell()
    with pytest.raises(RuntimeError, match="_start_correction"):
        c.piece("program").Program(c, "cpu")


def test_reference_marches_on_the_answers_steps(f64):
    """Each replay records its accepted step times by its final time; the
    reference marches on them, and a recorded step that fails its own
    float64 error test gives fields of NaN, which fail the judge."""
    from reference import answer_steps
    prog, (a, _) = f64
    times = answer_steps.of(a[0])
    assert len(times) == STEPS and times[-1] == a[0]
    assert list(times) == sorted(times) and times[0] > 0
    c = cell()
    ref = check.reference_case(c, "cpu")
    t, n, w, v = check.march_segment(ref, c, SEED, t_end=a[0])
    assert (t, n) == (a[0], STEPS) and np.isfinite(w).all()
    answer_steps.record([0.5])      # one step far past the error test
    t, n, w, v = check.march_segment(ref, c, SEED, t_end=0.5)
    assert (t, n) == (0.5, 1) and np.isnan(w).all() and np.isnan(v).all()
    verdict = check.judge(c, [(0.5, STEPS, w, v)], SEED, "cpu",
                          log=lambda m: None)
    assert verdict["failed"] == 1


def test_answer_steps_keep_one_sequence_per_final_time(monkeypatch):
    """The record keeps each march's step times under its final time; two
    marches that end at the same time on other steps leave none there,
    so the reference steps with its own controller."""
    from reference import answer_steps
    monkeypatch.setattr(answer_steps, "TIMES", {})
    answer_steps.record([])
    assert answer_steps.TIMES == {}
    answer_steps.record([0.1, 0.25])
    answer_steps.record((0.1, 0.25))
    assert answer_steps.of(0.25) == (0.1, 0.25)
    assert answer_steps.of(0.1) is None
    answer_steps.record([0.2, 0.25])
    assert answer_steps.of(0.25) is None
    answer_steps.record([0.1, 0.25])
    assert answer_steps.of(0.25) is None


def test_program_fails_an_undersolved_correction(monkeypatch):
    """A replay whose correction CG stops above 10 x the mix's corr_rtol
    answers with fields of NaN, and the judge fails it."""
    from pynama_tpu_torch.ibm import interpolation as I
    c = cell()
    prog = c.piece("program").Program(c, "cpu")
    full = I.correction_cg
    monkeypatch.setattr(I, "correction_cg",
                        lambda *a, **k: full(*a, **dict(k, maxiter=1)))
    prog.load(*check.start_state(c, prog.coords, SEED))
    ans = prog.replay()
    assert max(r for _, r in prog.problem.corr_log) > 10 * 1e-12
    assert ans[1] == STEPS and np.isnan(ans[2]).all()
    v = check.judge(c, [ans], SEED, "cpu", log=lambda m: None)
    assert v["failed"] == 1


@pytest.mark.parametrize("key, value", [("corr_rtol", 1e-6),
                                        ("corr_maxiter", 50)])
def test_program_refuses_other_correction_settings(key, value):
    """The mix states the correction CG's tolerance and cap; a port whose
    own differ is refused at set-up."""
    c = cell()
    c = dataclasses.replace(c, mix={**c.mix, key: value})
    with pytest.raises(RuntimeError, match="correction CG settings"):
        c.piece("program").Program(c, "cpu")


def test_cell_limits_see_an_undersolved_correction(monkeypatch):
    """The cell's own limits over its own 10 steps, in float32 on the cut
    mesh: the program's answer passes them, and one whose correction CG
    stopped at rtol 1e-2 (the program module's check of the residual set
    aside) fails them, judged on its own steps."""
    limits = json.load(open(LIMITS))
    c = dataclasses.replace(cell(precision="float32", steps=10),
                            limits=limits)
    prog = c.piece("program").Program(c, "cpu")
    prog.cell = dataclasses.replace(c, mix={**c.mix, "corr_rtol": 1.0})
    prog.load(*check.start_state(c, prog.coords, SEED))
    good = prog.replay()
    p = prog.problem
    start = p._start_correction

    def loose():
        start()
        p._corr_rtol = 1e-2

    monkeypatch.setattr(p, "_start_correction", loose)
    bad = prog.replay()
    assert good[1] == bad[1] == 10 and good[0] != bad[0]
    quiet = dict(log=lambda m: None)
    assert check.judge(c, [good], SEED, "cpu", **quiet)["failed"] == 0
    v = check.judge(c, [bad], SEED, "cpu", **quiet)
    assert v["failed"] == 1
    assert v["numbers"]["vort_rel"] > 3 * limits["vort_rel"]


def test_f32_fails_the_f64_tolerances():
    c = cell(precision="float32")
    _, (ans,) = replays(c)
    v = check.judge(c, [ans], SEED, "cpu", log=lambda m: None)
    assert ans[1] == STEPS
    assert v["numbers"]["vel_rel"] > 100 * VEL_TOL
    assert v["numbers"]["vort_rel"] > 100 * VORT_TOL
    assert v["failed"] == 1


def test_reference_body_is_the_ports(f64):
    """The reference's own restatement of the body, the stream and the
    index-space fourGrid delta gives the port's numbers: points, dl, h,
    the free stream and, at a moved position, the port's support tables
    as a dense W."""
    from pynama_tpu_torch.ibm import interpolation as I
    prog, _ = f64
    p = prog.problem
    ref = check.reference_case(cell(), "cpu")
    assert ref.L == p.body.n_nodes == 8
    assert ref.dl == pytest.approx(p.body.dl, rel=1e-15)
    assert ref.h == pytest.approx(p.h, rel=1e-15)
    np.testing.assert_allclose(ref.u_inf, [2.8, 0.0], rtol=1e-15)
    assert p.U_ref == pytest.approx(2.8, rel=1e-15)
    t = 0.37
    p.body.update_parameters(t)
    points, vb = ref.body(t)
    np.testing.assert_allclose(points, p.body.coordinates(), atol=1e-15)
    np.testing.assert_allclose(vb, p.body.velocities(), atol=1e-15)
    nodes, w = I.support_tables(p.ibm_ops, torch.as_tensor(points))
    dense = np.zeros((ref.L, ref.n))
    np.put_along_axis(dense, nodes.numpy(), w.numpy(), axis=1)
    np.testing.assert_allclose(ref.interpolation(points).numpy(), dense,
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(dense.sum(axis=1), 1.0, atol=1e-14)


def test_reference_refuses_another_case():
    from reference.ibm_cylinder import Case
    case = json.load(open(CONFIG))["case"]
    case["domain"]["box-mesh"]["nelem"] = [4, 4]
    for bad in ({"boundary-conditions": {"free-slip": {"up": [1, 0]}}},
                {"bodies": [dict(case["bodies"][0], vel="static")]}):
        with pytest.raises(ValueError):
            Case(dict(copy.deepcopy(case), **bad), device="cpu")


def test_reference_loads_nothing_of_the_port():
    code = (
        "import json, sys\n"
        "from reference.ibm_cylinder import Case\n"
        f"c = json.load(open({CONFIG!r}))['case']\n"
        "c['domain']['box-mesh']['nelem'] = [4, 4]\n"
        "Case(c, device='cpu')\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH":
                              os.pathsep.join([ROOT, BENCH])})
    assert out.returncode == 0, out.stderr[-2000:]
    mods = set(out.stdout.split())
    assert "torch" in mods
    assert not mods & {"pynama_tpu_torch", "pynama_tpu", "jax", "jaxlib"}
