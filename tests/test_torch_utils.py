"""The port's utils/ (Timer, device_trace, ops_info) and the
operator report Problem.setUp logs at debug level, against the JAX
package's where both compute the same thing."""
import json
import logging
import time

import pytest
import torch

from pynama_tpu.cases import Problem as JProblem
from pynama_tpu.utils.report import ops_info as jops_info
from pynama_tpu_torch.cases import Problem as TProblem
from pynama_tpu_torch.utils import Timer
from pynama_tpu_torch.utils import profiling
from pynama_tpu_torch.utils.profiling import TRACE_FILE, device_trace
from pynama_tpu_torch.utils.report import (format_ops_info, ops_info,
                                           pytree_nbytes)

from test_engine import cavity_config

torch.set_num_threads(1)


def test_timer():
    t = Timer()
    with pytest.raises(RuntimeError):
        t.toc()
    t.tic()
    time.sleep(0.01)
    e = t.toc()
    assert e >= 0.01 and t.getTime() == e and str(t) == f"{e:.6f}s"


def test_device_trace_writes_chrome_trace(tmp_path):
    """The trace holds the block's ops and, as user annotations on the
    profiler's clock, the program's spans of a tiny rhs run inside it; the
    program's trace is on for the block only."""
    from pynama_tpu_torch.engine.local_engine import rhs_local
    p = TProblem(cavity_config(ngl=3, nelem=2, dim=2), device="cpu",
                 dtype=torch.float64, solver="cg")
    p.setUp()
    w = p.to_local(torch.rand((p.mesh.n_nodes, 1), dtype=torch.float64))
    v = p.to_local(p.vel)
    d = tmp_path / "trace"
    with device_trace(str(d)):
        x = torch.ones(64, 64)
        (x @ x).sum()
        rhs_local(p.engine_ops, 0.0, w, v)
        assert profiling._ACTIVE is not None
    assert profiling._ACTIVE is None
    path = d / TRACE_FILE
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"rhs.eval", "kle.solve", "pcg.apply"} <= spans


@pytest.mark.parametrize("solver", ["cg", "direct"])
def test_ops_info_matches(solver, caplog):
    cfg = cavity_config(ngl=3, nelem=2, dim=3)
    pj = JProblem(cfg, solver=solver)
    pj.setUp()
    caplog.set_level(logging.DEBUG, logger="pynama_tpu_torch.problem")
    pt = TProblem(cfg, device="cpu", dtype=torch.float64, solver=solver)
    pt.setUp()
    a, b = jops_info(pj), ops_info(pt)
    assert sorted(a) == sorted(b)
    for k in ("n_nodes", "n_cells", "dofs", "assembled_nnz_upper_bound"):
        assert a[k] == b[k]
    assert b["kle_solver_bytes"] > 0
    assert (b["engine_bytes"] > 0) == (solver == "cg")
    assert b["engine_bytes"] == pytree_nbytes(pt.engine_ops)
    logged = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("operators:")]
    assert logged == [format_ops_info(b)]


def test_pytree_nbytes_counts_each_tensor_once():
    import dataclasses
    import numpy as np

    @dataclasses.dataclass
    class Box:
        a: torch.Tensor
        b: tuple
        c: dict
        d: float = 1.0

    t = torch.zeros(10, dtype=torch.float64)
    box = Box(a=t, b=(t, np.zeros(3, dtype=np.float32)),
              c={"x": torch.zeros(2, 2, dtype=torch.float32)})
    assert pytree_nbytes(box) == 80 + 12 + 16
    assert pytree_nbytes(None) == 0


def test_solve_overhead_driver_on_cpu(monkeypatch):
    """exp/solve_overhead.py's port runs its chains with --device cpu (the
    plain versions) and reports the slopes; --device cuda without a card
    raises."""
    from pynama_tpu_torch.exp import solve_overhead
    out = solve_overhead.main(["2", "3", "--device", "cpu", "--applies",
                               "2", "6", "--solves", "1", "2", "--rounds",
                               "1"])
    assert out["device"] == "cpu" and out["chains"] == {
        "ks": 2, "kl": 6, "ss": 1, "sl": 2}
    assert out["cg_iters_per_solve"] > 0
    assert out["solve_over_apply"] == pytest.approx(
        out["warm_solve_ms"] * 1e3 / out["apply_us"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        solve_overhead.main(["2", "3", "--device", "cuda"])
