"""The check catches a broken timed path: the harness's run on the
fixture's tiny cells with the solver broken underneath must come out not
correct, once for each fault the cells can have (a step that returns its
state unchanged; an answer altered where it is produced). One card and no
batch: no exchange between chips and no half-batch to leave out."""
import os
import time

import pytest
import torch

from bench_paths import FIXTURE
from harness import check
from harness.cell import run_cell
from harness.spec import load_cell


def _run(name, tmp_path):
    cell = load_cell(name, spec_path=os.path.join(FIXTURE, "BENCHMARK.json"),
                     bench_dir=FIXTURE)
    return run_cell(cell, 2**31 + 99, 0.2, False,
                    t_start=time.perf_counter(), device="cpu",
                    out_dir=str(tmp_path), log=lambda m: None)


def _unchanged_local(monkeypatch):
    from pynama_tpu_torch.cases import problem as P
    orig = P.rhs_local

    def rhs(ops, t, vort, vel, stats=None):
        f, v = orig(ops, t, vort, vel, stats)
        return torch.zeros_like(f), v
    monkeypatch.setattr(P, "rhs_local", rhs)


def _unchanged_global(monkeypatch):
    from pynama_tpu_torch.cases import problem as P
    orig = P.Problem.rhs

    def rhs(self, t, vort, vel):
        f, v = orig(self, t, vort, vel)
        return torch.zeros_like(f), v
    monkeypatch.setattr(P.Problem, "rhs", rhs)


def _altered_local(monkeypatch):
    from pynama_tpu_torch.engine import local_engine as LE
    orig = LE.solve_kle_local

    def solve(*a, **k):
        vort, vel = orig(*a, **k)
        return vort, vel * (1 + 1e-3)
    monkeypatch.setattr(LE, "solve_kle_local", solve)


def _altered_global(monkeypatch):
    from pynama_tpu_torch.solver import kle
    orig = kle._masked_solve

    def solve(*a, **k):
        return orig(*a, **k) * (1 + 1e-3)
    monkeypatch.setattr(kle, "_masked_solve", solve)


@pytest.mark.parametrize("name,fault", [
    ("tiny2d.cg", _unchanged_local), ("tiny2d.direct", _unchanged_global),
    ("tiny3d.cg", _unchanged_local), ("tiny2d.cg", _altered_local),
    ("tiny2d.direct", _altered_global), ("tiny3d.cg", _altered_local)],
    ids=["unchanged-cg2d", "unchanged-direct", "unchanged-cg3d",
         "altered-cg2d", "altered-direct", "altered-cg3d"])
def test_fault_is_not_correct(name, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    r = _run(name, tmp_path)
    assert r["correct"] is False and r["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", ["tiny2d.cg", "tiny2d.direct", "tiny3d.cg"])
def test_sound_run_is_correct(name, tmp_path):
    assert _run(name, tmp_path)["correct"] is True


def test_every_answer_is_judged():
    """Answers that end at other times than the first are each judged
    against a march of their own, however many there are: three wrong
    ones at three other end times all fail beside the right one."""
    cell = load_cell("tiny2d.cg", os.path.join(FIXTURE, "BENCHMARK.json"),
                     FIXTURE)
    seed = 2**31 + 7
    dev = torch.device("cpu")
    a = check.answers(cell, [seed], dev)[seed]
    wrong = [(a[0] * (1 - 1e-3 * i), a[1], a[2] * 1.01, a[3])
             for i in (1, 2, 3)]
    logs = []
    v = check.judge(cell, [a, *wrong], seed, dev, log=logs.append)
    assert v["compared"] == 4 and v["failed"] == 3
    assert "4 march(es)" in logs[0]
    assert check.judge(cell, [a, a], seed, dev, log=logs.append)["failed"] \
        == 0 and "1 march(es), 2 answer(s)" in logs[1]
