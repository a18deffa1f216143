"""The port's CLI (pynama_tpu_torch.run_case) against the JAX package's
(pynama_tpu.run_case), the modes of tests/test_cli.py and tests/test_io.py.

Each run goes through both packages' `main` in its own working directory,
JAX on the CPU in float64 (tests/conftest.py) and the port with
`-device cpu -dtype float64`. Transient fields must agree to rtol 1e-6,
atol 1e-8 (the tolerance of tests/test_torch_transient.py: the CG solves
converge to their rtol, not to round-off, and the step controller
integrates the differences), with the same accepted steps and end times
within 1e-12; the output files must have the same names, datasets, shapes
and dtypes, and the .xmf indexes the same element tree.

The times of the steps between are held to STEP_T_TOL. The first steps'
dt factors are clipped, so their times agree exactly; from the third step
on dt follows the embedded error estimate, a difference of two RK
solutions ~1e-5 of the field, so solves that agree to ~1e-13 relative give
estimates that agree to ~1e-8 and dt (∝ estimate^(-1/5)) to ~2e-9 relative.
Measured here: at most 4.3e-10 on t ≤ 5 (direct and CG alike).
"""
import argparse
import json
import logging
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import h5py
import numpy as np
import pytest
import torch
import yaml

from pynama_tpu import run_case as jrc
from pynama_tpu.io.binary import load_snapshot as jload_snapshot
from pynama_tpu_torch import run_case as trc
from pynama_tpu_torch.cases import Problem as TProblem
from pynama_tpu_torch.io.binary import load_snapshot as tload_snapshot

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-6, 1e-8
STEP_T_TOL = 1e-8
PORT = ["-device", "cpu", "-dtype", "float64"]


def run_both(tmp_path, monkeypatch, args):
    """Run `args` through the JAX CLI in tmp/jax and the port's in
    tmp/torch; returns (jax dir, torch dir, the port's result)."""
    out = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        if name == "jax":
            jrc.main(args)
        else:
            out["torch"] = trc.main(args + PORT)
    monkeypatch.chdir(tmp_path)
    return tmp_path / "jax", tmp_path / "torch", out["torch"]


def h5_items(path):
    with h5py.File(path, "r") as f:
        items = {}
        f.visititems(lambda k, v: items.__setitem__(k, v[()]) if isinstance(
            v, h5py.Dataset) else None)
        attrs = dict(f.attrs)
    return items, attrs


def assert_h5_match(pj, pt, rtol=RTOL, atol=ATOL):
    """Same datasets, shapes and dtypes; values within the tolerance."""
    dj, aj = h5_items(pj)
    dt, at = h5_items(pt)
    assert sorted(dj) == sorted(dt), (pj, sorted(dj), sorted(dt))
    for k in dj:
        assert dj[k].shape == dt[k].shape and dj[k].dtype == dt[k].dtype, k
        np.testing.assert_allclose(dt[k], dj[k], rtol=rtol, atol=atol,
                                   err_msg=f"{pt}:{k}")
    assert sorted(aj) == sorted(at)
    return aj, at


def assert_xmf_match(pj, pt):
    """Same element tree; Time values within STEP_T_TOL, everything else
    equal."""
    ej, et = ET.parse(pj).getroot(), ET.parse(pt).getroot()
    nj, nt = list(ej.iter()), list(et.iter())
    assert len(nj) == len(nt)
    for a, b in zip(nj, nt):
        assert a.tag == b.tag and sorted(a.attrib) == sorted(b.attrib)
        for k in a.attrib:
            if a.tag == "Time":
                assert abs(float(a.attrib[k]) - float(b.attrib[k])) \
                    <= STEP_T_TOL
            else:
                assert a.attrib[k] == b.attrib[k]
        assert (a.text or "").strip() == (b.text or "").strip()
    return sum(1 for e in nj if e.tag == "Time")


def assert_dirs_match(dj, dt):
    """Every file of the JAX run's output directory, by name, in the
    port's: HDF5 compared dataset by dataset, .xmf by element tree."""
    names_j = sorted(p.name for p in dj.iterdir())
    assert names_j == sorted(p.name for p in dt.iterdir())
    for n in names_j:
        if n.endswith(".h5"):
            assert_h5_match(dj / n, dt / n)
        elif n.endswith(".xmf"):
            assert_xmf_match(dj / n, dt / n)
    return names_j


def case_copy(tmp_path, name, tag="copy", **changes):
    """A copy of the case file `name` with top-level sections updated."""
    cfg = jrc.load_case(name)
    for k, v in changes.items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            cfg[k] = {**cfg[k], **v}
        else:
            cfg[k] = v
    path = tmp_path / f"{name}-{tag}.yaml"
    path.write_text(yaml.dump(cfg))
    return str(path), cfg


def assert_checkpoints_match(pj, pt):
    aj, at = assert_h5_match(pj, pt)
    assert aj["step"] == at["step"]
    assert abs(aj["t"] - at["t"]) <= 1e-12
    assert json.loads(aj["config"]) == json.loads(at["config"])


@pytest.mark.parametrize("solver", ["direct", "cg"])
def test_production_run_matches(tmp_path, monkeypatch, solver):
    """taylor-green 3x3 ngl=3: the direct solve (global layout, device
    tensors in post) and CG (engine, K1's plain version here)."""
    args = ["-case", "taylor-green", "-log", "WARNING", "-nelem", "3", "3",
            "-ngl", "3", "-solver", solver, "-checkpoint", "ck.h5"]
    dj, dt, (p, t, steps) = run_both(tmp_path, monkeypatch, args)
    assert p.solver_method == solver
    assert (p.engine_ops is not None) == (solver == "cg")
    assert_checkpoints_match(dj / "ck.h5", dt / "ck.h5")
    names = assert_dirs_match(dj / "tg-test", dt / "tg-test")
    snaps = [n for n in names if n.startswith("vec-data-")]
    assert len(snaps) == steps >= 3 and "taylor-green.xmf" in names
    # the last snapshot holds the final state, in the state's dtype
    last, _ = h5_items(dt / "tg-test" / snaps[-1])
    assert last["fields/vorticity"].dtype == np.float64
    np.testing.assert_array_equal(last["fields/vorticity"],
                                  p.vort.numpy().ravel())
    assert t == pytest.approx(5.0, abs=1e-12)


def test_cavity3d_production_matches(tmp_path, monkeypatch):
    """cavity.yaml on a 2^3 ngl=3 mesh (cut to 2 steps) under CG."""
    path, _ = case_copy(tmp_path, "cavity",
                        **{"time-solver": {"end-time": 0.02,
                                           "max-steps": 2}})
    args = ["-case", path, "-log", "WARNING", "-nelem", "2", "2", "2",
            "-ngl", "3", "-solver", "cg", "-checkpoint", "ck.h5"]
    dj, dt, (p, t, steps) = run_both(tmp_path, monkeypatch, args)
    assert steps == 2 and p.engine_ops.is_ns and p.engine_ops.fused
    assert_checkpoints_match(dj / "ck.h5", dt / "ck.h5")
    assert len([n for n in assert_dirs_match(dj / "cavity-3d",
                                             dt / "cavity-3d")
                if n.endswith(".h5")]) == 3


def test_checkpoint_then_resume(tmp_path, monkeypatch):
    """-checkpoint at t = 0.5, then -resume to t = 1: the resumed run
    starts from the checkpoint's fields and time in both packages."""
    first, _ = case_copy(tmp_path, "taylor-green",
                         **{"time-solver": {"end-time": 0.5}})
    second, _ = case_copy(tmp_path, "taylor-green", tag="resume",
                          **{"time-solver": {"end-time": 1.0},
                             "save-dir": "resumed"})
    base = ["-log", "WARNING", "-nelem", "3", "3", "-ngl", "3",
            "-solver", "direct"]
    run_both(tmp_path, monkeypatch, ["-case", first, "-checkpoint",
                                     "ck.h5"] + base)
    dj, dt, (p, t, steps) = run_both(
        tmp_path, monkeypatch, ["-case", second, "-resume", "ck.h5",
                                "-checkpoint", "ck2.h5"] + base)
    assert p.start_time == pytest.approx(0.5, abs=1e-12) and steps >= 1
    assert p.vort.dtype == torch.float64 and p.vort.device.type == "cpu"
    assert_checkpoints_match(dj / "ck2.h5", dt / "ck2.h5")
    assert_dirs_match(dj / "resumed", dt / "resumed")


def test_fast_io_matches(tmp_path, monkeypatch):
    """-fast-io: manifest, .bin files, the converted HDF5/XDMF and
    load_snapshot across the two packages' files."""
    args = ["-case", "taylor-green", "-log", "WARNING", "-nelem", "3", "3",
            "-ngl", "3", "-solver", "cg", "-fast-io"]
    dj, dt, (p, t, steps) = run_both(tmp_path, monkeypatch, args)
    fj, ft = dj / "tg-test-fast", dt / "tg-test-fast"
    mj = json.loads((fj / "manifest.json").read_text())["snapshots"]
    mt = json.loads((ft / "manifest.json").read_text())["snapshots"]
    assert len(mj) == len(mt) == steps
    for a, b in zip(mj, mt):
        assert a["step"] == b["step"] and abs(a["t"] - b["t"]) <= STEP_T_TOL
        assert a["fields"] == b["fields"]
    bins = sorted(q.name for q in ft.iterdir() if q.suffix == ".bin")
    assert bins == sorted(q.name for q in fj.iterdir() if q.suffix == ".bin")
    assert len(bins) == 2 * steps
    for rec in mt:
        for name in rec["fields"]:
            a = jload_snapshot(str(ft), rec["step"], name)
            b = tload_snapshot(str(fj), rec["step"], name)
            np.testing.assert_array_equal(
                a, tload_snapshot(str(ft), rec["step"], name))
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # the converted ParaView layout equals the snapshots
    names = assert_dirs_match(dj / "tg-test", dt / "tg-test")
    assert len([n for n in names if n.startswith("vec-data-")]) == steps
    last, _ = h5_items(dt / "tg-test" / f"vec-data-{steps:05d}.h5")
    np.testing.assert_array_equal(
        last["fields/velocity"],
        tload_snapshot(str(ft), steps, "velocity").ravel())


def test_kle_mode_matches(tmp_path, monkeypatch, caplog):
    """-test kle: the logged |error| and the dumped fields."""
    caplog.set_level(logging.INFO)
    args = ["-case", "taylor-green", "-test", "kle", "-nelem", "4", "4",
            "-ngl", "4", "-solver", "direct"]
    dj, dt, (p, fields) = run_both(tmp_path, monkeypatch, args)
    err = float(np.linalg.norm(fields["error"]))
    logged = [r.getMessage() for r in caplog.records
              if r.name == "pynama_tpu.run_case" and "KLE |error|" in
              r.getMessage()]
    jerr = float(logged[0].split("=")[1])
    # the JAX package logs %.3e: compare to its 4 digits, and the port's
    # own log line to the digit
    assert abs(err - jerr) <= 5e-4 * jerr
    tlog = [r.getMessage() for r in caplog.records
            if r.name == "pynama_tpu_torch.run_case" and "KLE |error|" in
            r.getMessage()]
    assert tlog == [logged[0]]
    assert_dirs_match(dj / "tg-test", dt / "tg-test")
    # the error itself, unrounded, to 1e-10 relative: the dumped field
    with h5py.File(dj / "tg-test" / "vec-data-00000.h5") as f:
        jerr_full = float(np.linalg.norm(f["fields/error"][()]))
    assert abs(err - jerr_full) <= 1e-10 * jerr_full


@pytest.mark.parametrize("mode,out", [
    ("chart", "out-kle-chart-taylor-green.yaml"),
    ("operators", "out-operators-test-taylor-green.yaml"),
    ("chartkle", "out-kle-taylor-green.yaml")])
def test_chart_modes_match(tmp_path, monkeypatch, mode, out):
    args = ["-case", "taylor-green", "-test", mode, "-log", "WARNING",
            "-nelem", "3", "3", "-solver", "direct", "-max-ngl", "4"]
    dj, dt, _ = run_both(tmp_path, monkeypatch, args)
    yj = yaml.safe_load((dj / out).read_text())
    yt = yaml.safe_load((dt / out).read_text())
    assert sorted(yj) == sorted(yt)

    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        return list(np.ravel(x))

    np.testing.assert_allclose(flat(yt), flat(yj), rtol=1e-8, atol=0)
    pngs = sorted(q.name for q in dt.iterdir() if q.suffix == ".png")
    assert pngs == sorted(q.name for q in dj.iterdir() if q.suffix == ".png")
    assert len(pngs) == (0 if mode == "chartkle" else 1)


def test_tuning_flags_match(tmp_path, monkeypatch):
    """-cg-rtol/-maxiter/-tableau/-pc reach the solver as in the JAX
    package (the reference's -ksp_*/-ts_* setFromOptions analog)."""
    args = ["-case", "taylor-green", "-log", "WARNING", "-nelem", "3", "3",
            "-ngl", "3", "-solver", "cg", "-cg-rtol", "1e-8", "-maxiter",
            "500", "-tableau", "5dp", "-pc", "jacobi", "-checkpoint",
            "ck.h5"]
    dj, dt, (p, t, steps) = run_both(tmp_path, monkeypatch, args)
    ops = p.engine_ops
    assert (ops.cg_rtol, ops.cg_maxiter, ops.pc) == (1e-8, 500, "jacobi")
    assert_checkpoints_match(dj / "ck.h5", dt / "ck.h5")


def test_fused_off(tmp_path, monkeypatch):
    """-fused off runs the engine through the plain ops/local.py DSS (no
    fused_apply call) and gives the fields of -fused on."""
    from pynama_tpu_torch.ops.fused import fused_apply
    base = ["-case", "taylor-green", "-log", "WARNING", "-nelem", "3", "3",
            "-ngl", "3", "-solver", "cg"] + PORT
    runs = {}
    for flag in ("on", "off"):
        d = tmp_path / flag
        d.mkdir()
        monkeypatch.chdir(d)
        fused_apply.launches = 0
        calls = []
        monkeypatch.setattr(
            "pynama_tpu_torch.engine.local_engine.fused_apply",
            lambda *a, **k: calls.append(1) or fused_apply(*a, **k))
        p, t, steps = trc.main(base + ["-fused", flag])
        runs[flag] = (p, t, steps, len(calls))
    (pon, ton, son, con), (poff, toff, soff, coff) = runs["on"], runs["off"]
    assert pon.engine_ops.fused is True and poff.engine_ops.fused is False
    assert con > 0 and coff == 0
    assert (son, ton) == (soff, toff)
    np.testing.assert_allclose(poff.vort.numpy(), pon.vort.numpy(),
                               rtol=1e-12, atol=1e-14)
    ns = argparse.Namespace(fused="off", device="cpu", dtype="float64")
    assert trc._overrides(ns)["fused"] is False


def test_flag_errors(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    base = ["-case", "taylor-green", "-log", "WARNING", "-nelem", "3", "3",
            "-ngl", "3"] + PORT
    with pytest.raises(SystemExit):
        trc.main(["-case", "taylor-green", "-tableau", "bogus"] + PORT)
    with pytest.raises(SystemExit):
        trc.main(base + ["-fused-block", "2"])
    assert "Options the port leaves out" in capsys.readouterr().err
    # -ndev: the JAX package's refusals of the same calls (a slab split
    # needs nelem[0] % ndev == 0; sharding needs the engine, which "auto"
    # does not build for this small IBM case)
    ndev = base[:-len(PORT)] + ["-solver", "cg", "-ndev", "2"]
    for main in (jrc.main, lambda a: trc.main(a + PORT)):
        with pytest.raises(ValueError, match=r"nelem\[0\]=3 not divisible "
                                             "by 2 devices"):
            main(ndev)
    ibm = ["-case", "ibm-static", "-log", "WARNING", "-nelem", "4", "4",
           "-ndev", "2"]
    with pytest.raises(AssertionError, match="without engine"):
        jrc.main(ibm)
    with pytest.raises(ValueError, match="element-local engine"):
        trc.main(ibm + PORT)
    with pytest.raises(FileNotFoundError):
        trc.load_case("no-such-case-xyz")


def test_problem_refuses_fused_block():
    """Problem(..., fused_block=N) raises with the CLI's -fused-block
    message (the JAX package hands it to build_engine's Mosaic block
    probing, which the port leaves out); fused_block=None is taken."""
    cfg = trc.load_case("taylor-green")
    with pytest.raises(NotImplementedError) as err:
        TProblem(cfg, device="cpu", fused_block=2)
    assert str(err.value) == trc.FUSED_BLOCK_LEFT_OUT
    TProblem(cfg, device="cpu", fused_block=None)


def test_ndev_flag_matches(tmp_path, monkeypatch):
    """-ndev 2 through run_case: the taylor-green case (4x4 ngl=3, CG)
    and ibm-static (4x4, CG, cut to 2 steps in a copy) run sharded on 2
    gloo ranks and write the JAX package's -ndev 2 files."""
    base = ["-log", "WARNING", "-nelem", "4", "4", "-ngl", "3", "-solver",
            "cg", "-ndev", "2"]
    (tmp_path / "tg").mkdir()
    dj, dt, (p, t, steps) = run_both(tmp_path / "tg", monkeypatch,
                                     ["-case", "taylor-green"] + base)
    assert len(p.rank_stats) == 2 and steps >= 3
    assert_dirs_match(dj / "tg-test", dt / "tg-test")
    (tmp_path / "ibm").mkdir()
    path, cfg = case_copy(tmp_path / "ibm", "ibm-static",
                          **{"time-solver": {"max-steps": 2}})
    dj, dt, (p, t, steps) = run_both(tmp_path / "ibm", monkeypatch,
                                     ["-case", path] + base)
    assert type(p).__name__ == "ImmersedBoundaryStatic" and steps == 2
    assert_dirs_match(dj / cfg["save-dir"], dt / cfg["save-dir"])


@pytest.mark.parametrize("name", ["ibm-static", "ibm-dynamic"])
def test_ibm_case_through_main(name, tmp_path, monkeypatch):
    """An IBM case file (cut to 8^2 elements and 2 steps in a copy)
    through run_case.main gives the fields, steps and force history of
    run_case.make_problem driven directly on the same config."""
    monkeypatch.chdir(tmp_path)
    cfg = trc.load_case(name)
    cfg["time-solver"].update({"max-steps": 2, "end-time": 0.01})
    cfg["save-dir"] = str(tmp_path / "out")
    case = tmp_path / f"{name}-cut.yaml"
    case.write_text(yaml.safe_dump(cfg))
    p, t, steps = trc.main(["-case", str(case), "-log", "WARNING", "-nelem",
                            "8", "8", "-dt0", "1e-4"] + PORT)
    assert type(p).__name__ == ("ImmersedBoundaryDynamic" if name ==
                                "ibm-dynamic" else "ImmersedBoundaryStatic")
    q = trc.make_problem(cfg, device="cpu", dtype=torch.float64,
                         nelem=[8, 8])
    q.setUp()
    tq, sq = q.start_solver(dt0=1e-4)
    assert (steps, t) == (sq, tq) and steps == 2
    assert torch.equal(p.vort, q.vort) and torch.equal(p.vel, q.vel)
    assert p.history["cd"] == q.history["cd"]


def test_sumfact_reaches_problem(tmp_path, monkeypatch):
    """-sumfact is taken and reaches Problem and the engine: on a box mesh
    `on` sum-factorizes K and `off` keeps the dense K (as in the JAX
    package), with the same run to round-off."""
    monkeypatch.chdir(tmp_path)
    args = ["-case", "taylor-green", "-log", "WARNING", "-nelem", "3", "3",
            "-ngl", "3", "-solver", "cg", "-sumfact"]
    runs = {}
    for flag in ("off", "on"):
        runs[flag] = trc.main(args + [flag] + PORT)
        p = runs[flag][0]
        assert p.opts["sumfact"] is (flag == "on")
        assert p.engine_ops is not None
        assert (p.engine_ops.sumfact is not None) is (flag == "on")
    (poff, toff, soff), (pon, ton, son) = runs["off"], runs["on"]
    assert pon.engine_ops.KT.numel() == 0
    assert (son, ton) == (soff, toff)
    np.testing.assert_allclose(pon.vort.numpy(), poff.vort.numpy(),
                               rtol=1e-9, atol=1e-12)


def test_cuda_without_card_raises(tmp_path, monkeypatch):
    """-device defaults to cuda; without a card it raises, before any
    work, and never runs on the CPU instead."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["-device", "cuda"], ["-device", "cuda:0"]):
        with pytest.raises(RuntimeError, match="is_available"):
            trc.main(["-case", "taylor-green", "-nelem", "3", "3"] + extra)
    ns = argparse.Namespace(nelem=[3, 3])
    with pytest.raises(RuntimeError, match="is_available"):
        trc.time_solving(trc.load_case("taylor-green"), ns)
    assert not any(tmp_path.iterdir())


def test_module_entry_point(tmp_path):
    """`python -m pynama_tpu_torch.run_case` (the __main__ path), in a
    process that never imports jax."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    code = ("import runpy, sys; sys.argv = ['run_case'] + sys.argv[1:]; "
            "runpy.run_module('pynama_tpu_torch.run_case', "
            "run_name='__main__'); "
            "assert 'jax' not in sys.modules and "
            "'pynama_tpu' not in sys.modules")
    r = subprocess.run(
        [sys.executable, "-c", code, "-case", "taylor-green", "-test", "kle",
         "-nelem", "3", "3", "-ngl", "3", "-solver", "direct"] + PORT,
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "KLE |error|" in r.stderr
    assert (tmp_path / "tg-test" / "vec-data-00000.h5").exists()
    assert (tmp_path / "tg-test" / "taylor-green.xmf").exists()
