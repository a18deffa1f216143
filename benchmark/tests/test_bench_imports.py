"""Neither the harness nor the reference loads JAX or the JAX package, and
the reference loads nothing of the measured package. Module names are
compared by their top-level part, whole: `pynama_tpu_torch` begins with
`pynama_tpu` and is not it."""
import ast
import os
import subprocess
import sys

import pytest

from bench_paths import BENCH, FIXTURE, ROOT

JAX = {"jax", "jaxlib", "flax", "pynama_tpu"}


def _sources(sub=""):
    top = os.path.join(BENCH, sub)
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__",
                                                "_out", "_cache")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_sources_name_no_jax(path):
    names = set(_imported(path))
    assert not names & JAX
    if os.sep + "reference" + os.sep in path:
        assert "pynama_tpu_torch" not in names


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys; print(' '.join(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=ROOT, capture_output=True,
        text=True, timeout=600, env={**os.environ, "PYTHONPATH":
                                     os.pathsep.join([ROOT, BENCH])})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split()[-2000:])


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import reference.cavity, reference.setup\n"
        "from reference.cavity import Case\n"
        f"import json; c = json.load(open({FIXTURE!r} + "
        "'/configs/box2d-4-ngl3.json'))['case']\n"
        "r = Case(c, device='cpu')")
    assert not mods & (JAX | {"pynama_tpu_torch"})


def test_a_run_loads_no_jax():
    mods = _modules_after(
        "import time; from harness.spec import load_cell\n"
        "from harness.cell import run_cell\n"
        f"c = load_cell('tiny2d.cg', {FIXTURE!r} + '/BENCHMARK.json', "
        f"{FIXTURE!r})\n"
        "run_cell(c, 1, 0.1, True, t_start=time.perf_counter(), "
        f"device='cpu', out_dir={FIXTURE!r} + '/../_out', "
        "log=lambda m: None)")
    assert "pynama_tpu_torch" in mods
    assert not mods & JAX
