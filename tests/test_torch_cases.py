"""The analytic-function case files, port against the JAX package.

Each of the six custom-func cases of pynama_tpu/cases/yaml (read here by
the test only; the port does not read the JAX package's files) is cut to a
small mesh (ngl=3; 3 elements per axis in 2D, 2 in 3D) and a run of
DURATION from the file's start time, through both packages' Problem in
float64 on the CPU (CG at rtol 1e-13, the stepper at atol=rtol=1e-8).
Widths stay: material
properties, boundary and initial conditions and start time are the file's.
The initial and exact fields must agree to 1e-13; the transient must take
the same steps to the same end time with fields to rtol 1e-6, atol 1e-8
(tests/test_torch_transient.py's limits).
"""
import os

import numpy as np
import pytest
import torch
import yaml

from pynama_tpu.cases import Problem as JProblem
from pynama_tpu_torch.cases import Problem as TProblem

torch.set_num_threads(1)

YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pynama_tpu", "cases", "yaml")
FILES = ["taylor-green", "taylor-green3d", "taylor-green2d-3d", "senoidal",
         "flat-plate", "flat-plate-FSNS"]
OPTS = dict(solver="cg", cg_rtol=1e-13, cg_maxiter=4000)
DURATION = 0.004


def _reduced(name):
    with open(os.path.join(YAML, name + ".yaml")) as fh:
        cfg = yaml.safe_load(fh)
    box = cfg["domain"]["box-mesh"]
    dim = len(box["nelem"])
    cfg["domain"]["ngl"] = 3
    box["nelem"] = [3 if dim == 2 else 2] * dim
    ts = cfg["time-solver"]
    ts["max-steps"] = 50
    ts["end-time"] = float(ts["start-time"]) + DURATION
    return cfg


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


@pytest.mark.parametrize("name", FILES)
def test_case_file_matches(name):
    cfg = _reduced(name)
    pj = JProblem(cfg, **OPTS)
    pj.setUp()
    pt = TProblem(cfg, device="cpu", dtype=torch.float64, **OPTS)
    pt.setUp()
    assert pt.bc.bc_type == pj.bc.bc_type
    assert _rel(pt.vort.numpy(), pj.vort) <= 1e-13
    assert _rel(pt.vel.numpy(), pj.vel) <= 1e-13
    names = ("velocity", "vorticity", "convective", "diffusive")
    t0 = pt.start_time
    for got, want in zip(pt.exact_fields(t0 + 0.1, names),
                         pj.exact_fields(t0 + 0.1, names)):
        assert got.shape == want.shape
        if np.abs(np.asarray(want)).max() > 0:
            assert _rel(got.numpy(), want) <= 1e-13
    run = dict(atol=1e-8, rtol=1e-8, dt0=1e-3)
    tj, sj = pj.start_solver(**run)
    tt, st = pt.start_solver(**run)
    assert st == sj > 0
    assert abs(tt - tj) < 1e-12 and abs(tt - pt.end_time) < 1e-12
    np.testing.assert_allclose(pt.vort.numpy(), np.asarray(pj.vort),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(pt.vel.numpy(), np.asarray(pj.vel),
                               rtol=1e-6, atol=1e-8)
    assert np.isfinite(pt.vort.numpy()).all()
