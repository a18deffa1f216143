"""The static-cylinder drag driver of the port
(pynama_tpu_torch/exp/ibm_cd.py) against the JAX package's (exp/ibm_cd.py,
loaded by path), float64 on the CPU, and the port's committed drag
histories (pynama_tpu_torch/exp/ibm_cd_h100.json, float32 on the card)
against the JAX package's (exp/ibm_cd_r05.json, float32 on a TPU).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pynama_tpu_torch.exp import ibm_cd as T

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_ART = os.path.join(ROOT, "exp", "ibm_cd_r05.json")
PORT_ART = os.path.join(ROOT, "pynama_tpu_torch", "exp", "ibm_cd_h100.json")
#: port against JAX package, float64 on the CPU, CG rtol 1e-12: relative
#: to the scale of the force each history belongs to
RUN_RTOL = 1e-8
HISTORIES = ("cd", "cl", "cd_phys", "cl_phys")


def jax_module():
    spec = importlib.util.spec_from_file_location(
        "jax_ibm_cd", os.path.join(ROOT, "exp", "ibm_cd.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("args", [(35, 30.0), (70, 30.0), (12, 0.3, 9)])
def test_cfg_for_matches_jax(args):
    assert T.cfg_for(*args) == jax_module().cfg_for(*args)


def flat(history):
    return np.asarray([float(np.ravel(v)[0]) for v in history])


def test_short_run_matches_jax():
    """cfg_for(12, 0.3) through the JAX package's ImmersedBoundaryStatic
    (as exp/ibm_cd.py calls it, CG rtol 1e-12) and the port's driver
    `run` at the same settings: the same accepted steps and force times,
    and cd, cl, cd_phys, cl_phys within RUN_RTOL of the scale of their
    force (max(|cd|, |cl|), or of the physical pair: the cylinder's lift
    is round-off of a symmetric flow); the record's tail as exp/ibm_cd.py
    reckons it."""
    from pynama_tpu.cases.ibm import ImmersedBoundaryStatic

    J = jax_module()
    pj = ImmersedBoundaryStatic(J.cfg_for(12, 0.3), solver="cg",
                                cg_rtol=1e-12, cg_maxiter=800)
    pj.setUp()
    tj, sj = pj.start_solver(rtol=1e-4, atol=1e-4)
    pt, rec = T.run(12, 0.3, torch.device("cpu"), torch.float64,
                    cg_rtol=1e-12)
    assert rec["steps"] == sj >= 5
    assert rec["t_reached"] == pytest.approx(tj, abs=1e-12)
    assert np.allclose(rec["times"], pj.history["times"], rtol=0,
                       atol=1e-12)
    hj = {k: flat(pj.history[k]) for k in HISTORIES}
    ht = {k: flat(pt.history[k]) for k in HISTORIES}
    for pair in (("cd", "cl"), ("cd_phys", "cl_phys")):
        scale = max(np.abs(hj[k]).max() for k in pair)
        for k in pair:
            gap = np.abs(ht[k] - hj[k]).max() / scale
            assert gap <= RUN_RTOL, (k, gap)
    times = np.asarray(pj.history["times"])
    cd = np.asarray(pj.history["cd_phys"])
    tail = cd[times > 0.7 * tj] if (times > 0.7 * tj).any() else cd[-5:]
    assert rec["cd_phys_tail_mean"] == pytest.approx(tail.mean(), rel=1e-8)
    assert rec["cd_phys"] == ht["cd_phys"].tolist()
    assert rec["lag_points"] == pj.body.n_nodes and rec["h"] == pj.h


@pytest.fixture(scope="module")
def arts():
    return load(PORT_ART), load(TPU_ART)


@pytest.mark.parametrize("nelem", ["35", "50", "70"])
def test_port_drag_tail_within_tpu_spread(arts, nelem):
    """At each resolution the port's cd_phys tail mean (t > 0.7 t_end)
    lies within the TPU run's own tail std of the TPU's tail mean; the
    run reached t=30 on a card it names with its power limit."""
    port, tpu = arts
    a, b = port["runs"][nelem], tpu["runs"][nelem]
    assert a["t_reached"] == pytest.approx(30.0, abs=1e-9)
    assert (a["h"], a["lag_points"]) == (b["h"], b["lag_points"])
    gap = abs(a["cd_phys_tail_mean"] - b["cd_phys_tail_mean"])
    assert gap <= b["cd_phys_tail_std"], (nelem, a["cd_phys_tail_mean"],
                                          b["cd_phys_tail_mean"],
                                          b["cd_phys_tail_std"])
    assert a["k1_launches"] == a["k1_applications"] > 0
    cfg = port["config"]
    assert cfg["device"].startswith("NVIDIA") and " W" in cfg["nvidia_smi"]
    assert cfg["dtype"] == "float32"
