"""BENCHMARK.json keeps to the benchmark contract's static rules, and each
name it gives leads to the file of that name."""
import json
import os
import re


from bench_paths import BENCH, ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][:2] == ["python3", "benchmark/run.py"]
    assert all(_line(w) for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    n = 24
    runs = 2 + 14 * n
    assert runs * (SPEC["run_seconds"] + 60) + n * 180 + 1200 <= 43200


def test_configs():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        f = json.load(open(os.path.join(ROOT, c["file"])))
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        assert f["precision"] in ("float32", "float64")
        for kind, sub in (("program", "programs"), ("reference", "reference"),
                          ("start", "starts")):
            assert os.path.exists(os.path.join(BENCH, sub,
                                               f"{f[kind]}.py")), kind
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_workloads():
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
        for sub, name in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(BENCH, sub, f"{name}.json"))
    assert len(pairs) == len(SPEC["workloads"]) <= 24


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = list(e2e)
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        names.append(m["name"])
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
    for cell in cells:     # every cell: setup_s, one more e2e, one layer
        assert sum(1 for m in SPEC["per_layer"]
                   if cell in m["workloads"]) >= 1
