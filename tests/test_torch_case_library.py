"""Every bundled case file through the port's driver path, against the JAX
package: run_case.make_problem -> setUp -> setup_viewer -> run at the tiny
overrides of tests/test_case_library.py, float64 on the CPU, the final
fields compared (rtol 1e-6, atol 1e-8: the tolerance of
tests/test_torch_transient.py), with the same accepted steps and end
times within STEP_T_TOL (a run that stops at max-steps ends at a step time,
which tests/test_torch_cli.py explains). The IBM case files run at the cut
meshes of tests/test_case_library.py's IBM cases with a snapshot every
step, so the IBM fields (ibm_zone, affected_nodes) and the force-history
yaml are written and read back. The port's case directory holds the JAX
package's files byte for byte."""
import filecmp
import os

import h5py
import numpy as np
import pytest
import torch
import yaml

from pynama_tpu import run_case as jrc
from pynama_tpu_torch import run_case as trc

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-8
STEP_T_TOL = 1e-8
IBM_CASES = ["ibm-static", "ibm-dynamic", "ibm-sphere"]


def _box(nelem):
    dim = len(nelem)
    return {"nelem": list(nelem), "lower": [0] * dim, "upper": [1] * dim}


def _tiny(name, cfg, tmp_path):
    """The overrides tests/test_case_library.py runs each case at."""
    dom = cfg.setdefault("domain", {})
    t0 = float(cfg.get("time-solver", {}).get("start-time", 0))
    if name in ("uniform", "taylor-green", "senoidal", "flat-plate",
                "cavity-2d"):
        dom["box-mesh"], dom["ngl"] = _box([3, 3]), 3
        ts = {"start-time": t0, "end-time": t0 + 0.005, "max-steps": 3}
    elif name in ("taylor-green3d", "taylor-green2d-3d"):
        dom["box-mesh"], dom["ngl"] = _box([2, 2, 2]), 3
        ts = {"start-time": 0, "end-time": 0.002, "max-steps": 2}
    elif name in ("diagonal-cavity", "cavity"):
        # cavity.yaml has no case in tests/test_case_library.py; it runs
        # at diagonal-cavity's overrides
        dom["box-mesh"]["nelem"] = [2, 2, 2]
        dom["ngl"] = 3
        ts = {"start-time": 0, "end-time": 0.02, "max-steps": 3}
    elif name == "flat-plate-FSNS":
        dom["box-mesh"]["nelem"], dom["ngl"] = [3, 3], 3
        ts = {"start-time": t0, "end-time": t0 + 0.01, "max-steps": 3}
    else:
        raise KeyError(name)
    cfg["time-solver"] = ts
    cfg["save-dir"] = str(tmp_path / "out")
    return cfg


CASES = sorted(f[:-5] for f in os.listdir(trc.CASE_DIR)
               if f.endswith(".yaml") and not f.startswith("ibm-"))


def test_case_files_are_the_jax_packages():
    names = sorted(os.listdir(jrc.CASE_DIR))
    assert names == sorted(os.listdir(trc.CASE_DIR)) and len(names) == 13
    match, mismatch, errors = filecmp.cmpfiles(
        jrc.CASE_DIR, trc.CASE_DIR, names, shallow=False)
    assert match == names and not mismatch and not errors


@pytest.mark.parametrize("name", CASES)
def test_case_matches(name, tmp_path, monkeypatch):
    out = {}
    for pkg, rc in (("jax", jrc), ("torch", trc)):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        cfg = _tiny(name, rc.load_case(name), d)
        kw = dict(device="cpu", dtype=torch.float64) if pkg == "torch" \
            else {}
        p = rc.make_problem(cfg, **kw)
        p.setUp()
        p.setup_viewer()
        t, steps = p.run()
        out[pkg] = (p, t, steps, d / "out")
    (pj, tj, sj, dj), (pt, tt, st, dt) = out["jax"], out["torch"]
    assert sj == st >= 1 and abs(tj - tt) <= STEP_T_TOL
    assert pt.solver_method == pj.solver_method
    np.testing.assert_allclose(pt.vort.numpy(), np.asarray(pj.vort),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pt.vel.numpy(), np.asarray(pj.vel),
                               rtol=RTOL, atol=ATOL)
    assert np.isfinite(pt.vort.numpy()).all()
    files = sorted(f.name for f in dj.iterdir())
    assert files == sorted(f.name for f in dt.iterdir())
    assert "mesh.h5" in files and f"{pt.case_name}.xmf" in files
    assert sum(f.startswith("vec-data-") for f in files) == st


#: tests/test_case_library.py's cut meshes and runs of the IBM case files
IBM_TINY = {"ibm-static": ([12, 12], 0.005), "ibm-dynamic": ([12, 12], 0.002),
            "ibm-sphere": ([8, 6, 6], 0.002)}


@pytest.mark.parametrize("name", IBM_CASES)
def test_ibm_case_runs(name, tmp_path, monkeypatch):
    out = {}
    for pkg, rc in (("jax", jrc), ("torch", trc)):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        cfg = rc.load_case(name)
        nelem, end = IBM_TINY[name]
        cfg["domain"]["box-mesh"]["nelem"] = nelem
        cfg["time-solver"] = {"start-time": 0, "end-time": end,
                              "max-steps": 2}
        cfg["save-dir"] = str(d / "out")
        cfg["save-n-steps"] = 1
        kw = dict(device="cpu", dtype=torch.float64) if pkg == "torch" \
            else {}
        p = rc.make_problem(cfg, **kw)
        p.setUp()
        p.setup_viewer()
        t, steps = p.run(dt0=1e-4)
        out[pkg] = (p, t, steps, d / "out")
    (pj, tj, sj, dj), (pt, tt, st, dt) = out["jax"], out["torch"]
    assert type(pt).__name__ == type(pj).__name__
    assert sj == st == 2 and abs(tj - tt) <= STEP_T_TOL
    np.testing.assert_allclose(pt.vort.numpy(), np.asarray(pj.vort),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pt.vel.numpy(), np.asarray(pj.vel),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pt.history["cd"], pj.history["cd"],
                               rtol=RTOL)
    files = sorted(f.name for f in dj.iterdir())
    assert files == sorted(f.name for f in dt.iterdir())
    assert sum(f.startswith("vec-data-") for f in files) == st
    with h5py.File(dj / f"vec-data-{st:05d}.h5") as fj, \
            h5py.File(dt / f"vec-data-{st:05d}.h5") as ft:
        for k in ("ibm_zone", "affected_nodes"):
            zone = ft[f"/fields/{k}"][()]
            np.testing.assert_array_equal(zone, fj[f"/fields/{k}"][()])
            assert zone.sum() > 0
        touched = np.zeros(pt.mesh.n_nodes)
        touched[np.unique(pt.nodes_tab.numpy())] = 1.0
        np.testing.assert_array_equal(ft["/fields/ibm_zone"][()].ravel(),
                                      touched)
    with open(str(dt) + ".yaml") as f:
        hist = yaml.safe_load(f)
    assert hist["steps"] == [1, 2] and hist["lagPoints"] == pt.body.n_nodes
