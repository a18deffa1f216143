"""The plain reference against the measured package at tiny box sizes, in
float64 on the CPU: the operators, one rhs and a short march."""
import numpy as np
import pytest
import torch

import bench_paths  # noqa: F401 (puts the benchmark on sys.path)
from reference.cavity import Case, round_tf32
from harness.traffic import perturbation


def _case(nelem, ngl, lid, kind="no-slip"):
    dim = len(nelem)
    zero = [0] * dim
    sides = ("up", "down", "left", "right") + (("back", "front")
                                               if dim == 3 else ())
    return {"name": "box", "material-properties": {"rho": 0.5, "mu": 0.01},
            "domain": {"ngl": ngl, "box-mesh": {
                "nelem": list(nelem), "lower": zero, "upper": [1] * dim}},
            "time-solver": {"start-time": 0, "end-time": 1.0,
                            "max-steps": 2},
            "boundary-conditions": {kind: {
                s: (lid if s == "up" else zero) for s in sides}},
            "initial-conditions": {"vorticity": [0] * (3 if dim == 3
                                                       else 1)}}


def _pair(case, direct_max_dofs):
    from pynama_tpu_torch.cases import Problem
    p = Problem(case, device="cpu", dtype=torch.float64, solver="cg",
                cg_rtol=1e-13, cg_maxiter=5000)
    p.setUp()
    r = Case(case, device="cpu", cg_rtol=1e-13,
                      direct_max_dofs=direct_max_dofs)
    return p, r


def _start(r, seed):
    dim = r.dim
    w = perturbation(r.coords, [0] * dim, [1] * dim, r.dim_w, seed, 0.1, 2)
    return (torch.as_tensor(w),
            torch.zeros((r.n, dim), dtype=torch.float64))


CASES = [((4, 4), 3, [2, 0]), ((3, 2), 4, [1, 0]), ((2, 2, 2), 3, [2, 0, 0]),
         ((2, 1, 2), 4, [1, 0, 0])]


@pytest.mark.parametrize("nelem,ngl,lid", CASES)
def test_mesh_and_operators(nelem, ngl, lid):
    p, r = _pair(_case(nelem, ngl, lid), 40_000)
    assert np.array_equal(r.coords, p.mesh.coords)
    v = torch.as_tensor(np.random.default_rng(0).standard_normal((r.n,
                                                                  r.dim)))
    op = p.operator
    for mine, theirs in ((r.curl(v), op.curl(v)), (r.srt(v), op.srt(v))):
        assert torch.allclose(mine, theirs, rtol=0, atol=1e-12 *
                              float(theirs.abs().max()))
    s = r.srt(v)
    assert torch.allclose(r.div_srt(s), op.div_srt(s), rtol=0,
                          atol=1e-12 * float(op.div_srt(s).abs().max()))


@pytest.mark.parametrize("nelem,ngl,lid", CASES)
@pytest.mark.parametrize("direct", [True, False], ids=["chol", "cg"])
def test_rhs(nelem, ngl, lid, direct):
    p, r = _pair(_case(nelem, ngl, lid), 40_000 if direct else 0)
    w, v = _start(r, 7)
    f_ref, vel_ref = r.rhs(0.0, w, v)
    f, vel = p.rhs(0.0, w, v)
    assert float((vel - vel_ref).norm() / vel_ref.norm()) < 1e-10
    assert float((f - f_ref).norm() / f_ref.norm()) < 1e-9


@pytest.mark.parametrize("nelem,ngl,lid", CASES[:3])
def test_march(nelem, ngl, lid):
    case = _case(nelem, ngl, lid)
    p, r = _pair(case, 40_000)
    w, v = _start(r, 2**31 + 11)
    p.vort, p.vel = w.clone(), v.clone()
    t, steps = p.start_solver(dt0=1e-3)
    tr, wr, vr, sr = r.march(w, v, t, 1e-3, 1e-4, 1e-4)
    assert (tr, sr) == (t, steps) == (t, 2)
    assert float((p.vort - wr).norm() / wr.norm()) < 1e-10
    assert float((p.vel - vr).norm() / vr.norm()) < 1e-10


def test_free_slip_sides():
    case = _case((3, 3), 3, [1, 0], kind="free-slip")
    p, r = _pair(case, 40_000)
    w, v = _start(r, 3)
    f_ref, _ = r.rhs(0.0, w, v)
    f, _ = p.rhs(0.0, w, v)
    assert len(r.systems) == 1
    assert float((f - f_ref).norm() / f_ref.norm()) < 1e-9


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0e-5,
                      1.0 + 2**-12], dtype=torch.float32)
    y = round_tf32(x)
    assert y.tolist()[:2] == [1.0, 1.0 + 2**-10]      # a tie rounds away
    assert y[2] == 1.0 + 2**-10
    assert y[4] == 1.0
    m = y.view(torch.int32) & 0x1FFF
    assert int(m.abs().sum()) == 0
