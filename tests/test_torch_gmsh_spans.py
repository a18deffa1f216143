"""The spans of the engine's unstructured route (engine/local_engine.py):
on a gmsh hex mesh with tracing on, `apply_k.element` opens once per K
application (around the element product, attrs route, E, ngl),
`dss.gather` once per gather DSS (attr ncomp) and `bc.func` once per loop
over the analytic-function sides (attr sides); on a box mesh, where K1
applies the operators, none of them opens, and with tracing off none
records. A 2^3 distorted hex Taylor-Green case and its 2^3 box twin,
float64 on the CPU."""
import pytest
import torch

from pynama_tpu_torch.cases import Problem
from pynama_tpu_torch.engine import local_engine as LE
from pynama_tpu_torch.exp import write_hex_msh
from pynama_tpu_torch.utils import profiling
from pynama_tpu_torch.utils.profiling import tracing

torch.set_num_threads(1)

SPANS = ("apply_k.element", "dss.gather", "bc.func")
TG3D = {"custom-func": {"name": "taylor_green3d"}}


def _problem(domain, **opts):
    cfg = {"name": "tg3d", "material-properties": {"rho": 0.5, "mu": 0.01},
           "domain": domain, "boundary-conditions": TG3D,
           "initial-conditions": TG3D,
           "time-solver": {"start-time": 0, "end-time": 0.01,
                           "max-steps": 2}}
    p = Problem(cfg, device="cpu", dtype=torch.float64, solver="cg",
                cg_rtol=1e-10, cg_maxiter=500, **opts)
    p.setUp()
    return p


def gmsh(tmp_path, sumfact=True):
    path = write_hex_msh(str(tmp_path / "hex.msh"), 2, 2, 2, 0.12)
    return _problem({"ngl": 3, "gmsh-file": path}, sumfact=sumfact)


def box():
    return _problem({"ngl": 3, "box-mesh": {
        "nelem": [2, 2, 2], "lower": [0, 0, 0], "upper": [1, 1, 1]}})


class Counter:
    """Wraps module attribute `name` and counts its calls."""

    def __init__(self, monkeypatch, module, name):
        self.n, orig = 0, getattr(module, name)

        def run(*a, **k):
            self.n += 1
            return orig(*a, **k)
        monkeypatch.setattr(module, name, run)


@pytest.fixture
def trace():
    tr = tracing()
    yield tr
    tr.stop()


def _rhs(p):
    return LE.rhs_local(p.engine_ops, 0.003, p.to_local(p.vort),
                        p.to_local(p.vel))


@pytest.mark.parametrize("sumfact", [True, False])
def test_gmsh_route_opens_its_spans(tmp_path, monkeypatch, trace, sumfact):
    p = gmsh(tmp_path, sumfact)
    ops = p.engine_ops
    assert not ops.lay_v.structured and len(ops.func_sides) == 6
    prod = Counter(monkeypatch, LE.S, "apply_sumfact_k") if sumfact \
        else Counter(monkeypatch, LE.L, "emm")
    gathers = Counter(monkeypatch, LE.L, "dss")
    loops = Counter(monkeypatch, LE, "_write_func_sides")
    applies = Counter(monkeypatch, LE, "apply_K")
    _rhs(p)
    recs = trace.records()
    by = {n: [r for r in recs if r.name == n] for n in SPANS}
    # every K application is one element product; dense emm also serves
    # Rw, curl, srt and div, so count the products by apply_K there
    assert len(by["apply_k.element"]) == applies.n > 0
    if sumfact:
        assert prod.n == applies.n
    for r in by["apply_k.element"]:
        assert r.attrs == {"route": "sumfact" if sumfact else "dense",
                           "E": 8, "ngl": 3}
    assert len(by["dss.gather"]) == gathers.n > applies.n
    assert {r.attrs["ncomp"] for r in by["dss.gather"]} == {3, 6}
    # one rhs of the one-stage (custom-func) case: vorticity and velocity
    assert len(by["bc.func"]) == loops.n == 2
    assert all(r.attrs == {"sides": 6} for r in by["bc.func"])
    names = trace.names
    parent = {i: names[trace.parent[i]] if trace.parent[i] >= 0 else None
              for i in range(len(names))}
    assert all(parent[i] == "rhs.bc" for i, n in enumerate(names)
               if n == "bc.func")


def test_box_mesh_opens_none_of_them(monkeypatch, trace):
    p = box()
    ops = p.engine_ops
    assert ops.lay_v.structured and ops.fused and len(ops.func_sides) == 6
    loops = Counter(monkeypatch, LE, "_write_func_sides")
    _rhs(p)
    assert loops.n == 2
    names = {r.name for r in trace.records()}
    assert "kle.solve" in names and not names & set(SPANS)


@pytest.mark.parametrize("mesh", ["gmsh", "box"])
def test_tracing_off_records_nothing(tmp_path, monkeypatch, mesh):
    assert profiling._ACTIVE is None
    p = gmsh(tmp_path) if mesh == "gmsh" else box()
    opened = []
    monkeypatch.setattr(profiling.Trace, "open",
                        lambda self, name: opened.append(name))
    f, _ = _rhs(p)
    assert opened == [] and torch.isfinite(f).all()


def test_spans_leave_the_fields_bitwise(tmp_path):
    p = gmsh(tmp_path)
    f0, v0 = _rhs(p)
    tr = tracing()
    try:
        f1, v1 = _rhs(p)
    finally:
        tr.stop()
    assert any(n == "apply_k.element" for n in tr.names)
    assert torch.equal(f0, f1) and torch.equal(v0, v1)
