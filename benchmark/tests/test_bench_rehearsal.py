"""A CPU rehearsal of a benchmark run on the fixture's tiny cells, with
the measured package's plain versions: set-up, the window, the spans of
the traced run and the check, down to the result line's keys; and the
command itself, which refuses to run without a card."""
import json
import os
import subprocess
import sys
import time

import pytest

from bench_paths import BENCH, FIXTURE, ROOT
from harness.cell import run_cell
from harness.spec import load_cell, load_named

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def _run(name, trace, tmp_path, seed=2**31 + 5):
    cell = load_cell(name, spec_path=os.path.join(FIXTURE, "BENCHMARK.json"),
                     bench_dir=FIXTURE)
    return cell, run_cell(cell, seed, 0.5, trace, t_start=time.perf_counter(),
                          device="cpu", out_dir=str(tmp_path),
                          log=lambda m: None)


@pytest.mark.parametrize("name", ["tiny2d.cg", "tiny2d.direct"])
def test_untraced_run(name, tmp_path):
    cell, r = _run(name, False, tmp_path)
    assert set(r) == KEYS and list(r)[-1] == "checks"
    assert set(r["device"]) == DEVICE_KEYS
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"step_s", "setup_s", "peak_mem_gb"}
    assert all(m["value"] >= 0 and m["unit"] for m in r["metrics"].values())
    assert set(r["checks"]) == {"vort_rel", "vel_rel"}
    for c in r["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    json.dumps(r)


def test_traced_run_reads_the_cells_own_metrics(tmp_path):
    """The fixture's cell and its metric module are found by their names
    in the fixture's files: a cell, a mix and a metric are added by files
    and entries alone."""
    cell, r = _run("tiny2d.cg", True, tmp_path)
    assert set(r) == KEYS and r["correct"]
    assert set(r["metrics"]) == {"stepper.rhs_per_step",
                                 "cg.iters_per_solve",
                                 "fixture.solves_per_rhs"}
    assert r["metrics"]["fixture.solves_per_rhs"]["value"] == 2.0
    assert r["metrics"]["stepper.rhs_per_step"]["value"] >= 8


def test_pieces_are_found_by_name():
    """A configuration's program, reference and start builder are the
    modules its file names, under the spec's own directory first: the
    fixture's 3D box names a start builder only the fixture has."""
    import numpy as np
    from harness import check
    cell = load_cell("tiny3d.cg", os.path.join(FIXTURE, "BENCHMARK.json"),
                     FIXTURE)
    start = cell.piece("start")
    assert start.__file__.startswith(FIXTURE)
    assert not cell.piece("program").__file__.startswith(FIXTURE)
    assert cell.piece("reference").Case.__name__ == "Case"
    coords = np.random.default_rng(0).random((50, 3))
    w, v = check.start_state(cell, coords, 11)
    w2, _ = load_named("starts", "modes_at_rest").build(cell.case, coords,
                                                        cell.mix, 11)
    assert np.array_equal(w, 0.5 * w2) and not v.any() and np.any(w)


def test_direct_route_metrics(tmp_path):
    cell, r = _run("tiny2d.direct", True, tmp_path)
    assert set(r["metrics"]) == {"stepper.rhs_per_step"}


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "cavity2d.direct", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 1 card" in p.stderr


def test_command_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, the
    command exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "_out", "_cache",
                                                  "__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cavity3d.jacobi", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
