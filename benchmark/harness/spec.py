"""Cell lookup: every piece of a cell is found by its name.

`BENCHMARK.json` names the cells, configurations and metrics; the files
behind the names sit in the benchmark's directory:

    configs/<config>.json   the case as it is run (key "case"), its source,
                            `reduced`, `assumed`, `precision`, and the
                            names of its program, reference and start
                            builder (below)
    traffic/<traffic>.json  the mix: solver route, preconditioner, CG
                            tolerance, dt0, RK tolerances, the segment, the
                            perturbation and the traced rhs range
    limits/<cell>.json      the limit of each number the check compares
    metrics/<metric>.py     one per-layer metric: `read(rec)` -> number or
                            None (nothing to read); optionally `SPANS`,
                            the layer callables it needs wrapped
                            (`spans.py`), and `prepare(program, profile)`,
                            run once after set-up in a traced run
    programs/<program>.py   `Program(cell, device)`: the measured solver
                            set up for the cell, its replay of the segment,
                            and `SPANS` its own trace needs
    reference/<ref>.py      `Case(case, device=, dtype=, tf32=, cg_rtol=,
                            cg_maxiter=)`: the plain reference's march
    starts/<start>.py       `build(case, coords, mix, seed)` -> the start
                            state (vorticity, velocity) on given nodes

A later cell, configuration, mix or metric is new files and new entries,
never an edit: each piece is loaded by the name its entry gives, from the
spec's own directory first (a test fixture) and then from the
benchmark's.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
DIRS = {"program": "programs", "reference": "reference", "start": "starts"}


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # the config file, whole
    mix: dict             # the traffic file
    limits: dict          # number name -> limit
    end_to_end: list      # the spec's entries this cell reports
    per_layer: list
    bench_dir: str        # where the cell's named pieces are looked up first

    @property
    def case(self) -> dict:
        return self.config["case"]

    def piece(self, kind: str):
        """The module the config names under `kind` ("program",
        "reference" or "start")."""
        return load_named(DIRS[kind], self.config[kind], self.bench_dir)

    def metric(self, name: str):
        return load_named("metrics", name, self.bench_dir)


def _json(path):
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: str | None = None,
              bench_dir: str | None = None) -> Cell:
    """The cell `name` of the spec at `spec_path` (the repository's
    BENCHMARK.json by default), its files under `bench_dir`."""
    spec_path = spec_path or os.path.join(ROOT, "BENCHMARK.json")
    bench_dir = bench_dir or BENCH_DIR
    spec = _json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload '{name}' in {spec_path} "
                       f"(have {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(bench_dir, "configs",
                                  f"{w['config']}.json")),
        mix=_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")),
        limits=_json(os.path.join(bench_dir, "limits", f"{name}.json")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir)


def load_named(sub: str, name: str, bench_dir: str | None = None):
    """The module <sub>/<name>.py, under `bench_dir` first and then under
    the benchmark's own directory."""
    paths = [os.path.join(d, sub, f"{name}.py")
             for d in (bench_dir or BENCH_DIR, BENCH_DIR)]
    path = next((p for p in paths if os.path.exists(p)), None)
    if path is None:
        raise FileNotFoundError(f"no {sub}/{name}.py in {paths}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{sub}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
