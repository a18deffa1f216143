"""The port's measurement drivers (pynama_tpu_torch/exp/fused_ab.py,
ngl7_blocks.py, sumfact_chip.py, sumfact_roofline.py, dss_gather_opt.py)
and their shared helpers in pynama_tpu_torch/exp/__init__.py, on the CPU:
the mesh writer byte for byte against bench.py's, the slope protocol, the
column-major gather DSS and the sumfact phases against the JAX package's
(float64, 1e-12), and each driver run end to end at a tiny size with its
agreement check (on the CPU every kernel wrapper takes its plain
version). The drivers' times mean something only on the card
(chip_smoke.py's analyses phase runs them there).
"""
import importlib
import os
import pkgutil
import sys

import numpy as np
import pytest
import torch

import pynama_tpu_torch
from pynama_tpu_torch import exp as X
from pynama_tpu_torch.exp import dss_gather_opt as G
from pynama_tpu_torch.exp import sumfact_roofline as R
from pynama_tpu_torch.mesh import mesh_from_gmsh
from pynama_tpu_torch.ops import local as L

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU, F64 = torch.device("cpu"), torch.float64
NEW = ("fs_spectrum", "fs_walls", "fs_woodbury", "fused_ab", "ngl7_blocks",
       "sumfact_chip", "sumfact_roofline", "dss_gather_opt")


def _jax_exp(name):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module(f"exp.{name}")


@pytest.mark.parametrize("shape", [(2, 2, 2, 0.12), (3, 2, 4, 0.0),
                                   (10, 10, 10, 0.12)])
def test_write_hex_msh_is_bench_bytes(tmp_path, shape):
    """write_hex_msh writes bench.py's _write_hex_msh file byte for byte
    (the default_rng(0) distortion included)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import bench
    theirs = bench._write_hex_msh(*shape[:3], distort=shape[3])
    try:
        ours = X.write_hex_msh(str(tmp_path / "hex.msh"), *shape[:3],
                               distort=shape[3])
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
    finally:
        os.unlink(theirs)


def test_chip_smoke_writes_the_package_mesh(tmp_path):
    """chip_smoke.write_hex_msh is the package's writer."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    a = chip_smoke.write_hex_msh(str(tmp_path / "a.msh"), 3, 3, 3, 0.12)
    b = X.write_hex_msh(str(tmp_path / "b.msh"), 3, 3, 3, 0.12)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _chain(scale):
    def make(n):
        def run(x):
            for _ in range(n):
                y = x * scale
                x = y / (1.0 + y.abs().max())
            return x
        return run
    return make


def test_interleaved_slopes_one_slope_per_variant():
    x = torch.ones(64, dtype=F64)
    res = X.interleaved_slopes([("a", _chain(2.0), (x,)),
                                ("b", _chain(3.0), (x,))],
                               n1=5, target_s=0.01, rounds=2)
    assert list(res) == ["a", "b"]
    for per, floor in res.values():
        assert per > 0 and floor > 0


@pytest.mark.parametrize("where", ["make", "run"])
def test_interleaved_slopes_raises_when_a_variant_fails(where):
    """A failing variant raises; it is not dropped from the result."""
    def bad_make(n):
        if where == "make":
            raise ValueError("no chain")
        return lambda x: x[10 ** 6]                 # IndexError on a run
    x = torch.ones(8, dtype=F64)
    with pytest.raises((ValueError, IndexError)):
        X.interleaved_slopes([("ok", _chain(2.0), (x,)),
                              ("bad", bad_make, (x,))],
                             n1=3, target_s=0.01, rounds=1)


def test_dss_cm_is_the_gather_dss(tmp_path):
    """The column-major trailing-gather DSS equals ops/local.py::dss and
    the JAX package's L.dss on a 3^3 hex mesh at ngl=3, float64."""
    import jax.numpy as jnp
    from pynama_tpu.mesh import mesh_from_gmsh as jax_mesh_from_gmsh
    from pynama_tpu.ops import local as JL
    path = X.write_hex_msh(str(tmp_path / "hex.msh"), 3, 3, 3, 0.12)
    mesh = mesh_from_gmsh(path, 3)
    c = 3
    lay = L.make_local_layout(mesh, c, device=CPU, dtype=F64)
    rng = np.random.default_rng(0)
    t = rng.standard_normal((mesh.n_cells, mesh.nnode_el * c))
    ours = G.make_dss_cm(mesh, c, CPU)(torch.as_tensor(t))
    plain = L.dss(lay, torch.as_tensor(t))
    jmesh = jax_mesh_from_gmsh(path, 3)
    theirs = np.asarray(JL.dss(JL.make_local_layout(jmesh, c,
                                                    dtype=jnp.float64),
                               jnp.asarray(t)))
    scale = np.abs(theirs).max()
    assert np.abs(ours.numpy() - plain.numpy()).max() <= 1e-13 * scale
    assert np.abs(ours.numpy() - theirs).max() <= 1e-13 * scale


def test_sumfact_phases_match_jax():
    """phase0, phase1 and the full apply on the distorted 2^3 hexes within
    1e-12 of the JAX package's exp/sumfact_roofline.py phases, float64."""
    import jax.numpy as jnp
    from pynama_tpu.basis.tables import make_tensor_basis as jax_basis
    from pynama_tpu.ops import sumfact as JSF
    J = _jax_exp("sumfact_roofline")
    sf, t = R.inputs(2, 4, CPU, F64)
    corners = R.distorted_corners(2, np.random.default_rng(0))
    jsf = JSF.build_sumfact(jax_basis(4, 3), corners, jnp.float64)
    jt = jnp.asarray(t.numpy())
    pairs = [(R.phase0(sf, t), J.phase0(jsf, jt)),
             (R.phase1(sf, t), J.phase1(jsf, jt)),
             (R.SF.apply_sumfact_k(sf, t), JSF.apply_sumfact_k(jsf, jt))]
    for ours, theirs in pairs:
        theirs = np.asarray(theirs)
        assert ours.shape == theirs.shape
        assert np.abs(ours.numpy() - theirs).max() \
            <= 1e-12 * np.abs(theirs).max()


def test_sumfact_roofline_counts():
    """The roofline at 10^3 hexes ngl=4: the docstring's 4.92 MB and
    0.21 GFLOP, operation-bound at ~3.1 us."""
    from pynama_tpu_torch.ops import sumfact as SF
    E, nn, nq = 1000, 64, (64, 27)
    fake = SF.SumFactK(
        Gt=torch.empty((E, 3, 3, nq[0])), Jrt=torch.empty((E, 3, 3, nq[1])),
        wr=torch.empty((E, nq[1])), Df_flat=None, Dr_flat=None, v2cm=None,
        cm2v=None, dim=3, ngl=4)
    roof = R.roofline(fake, torch.empty((E, 3 * nn)))
    assert roof["bytes"] == 4_920_000
    assert roof["flops"] == 209_664_000
    assert roof["bound_by"] == "operations"
    assert abs(roof["bound_us"] - 3.13) < 0.01


#: each driver at a tiny size on the CPU: argv, and what its result holds
DRIVERS = {
    "fused_ab": (["1", "--ne", "2", "--n1", "3", "--target-s", "0"],
                 ("fused_us", "unfused_us", "k1_applications")),
    "ngl7_blocks": (["--ne", "2", "--nit", "3", "--rounds", "1"],
                    ("fused_us", "unfused_us", "k1_applications")),
    "sumfact_chip": (["2", "--nit", "6", "2", "--rounds", "1"],
                     ("sumfact_us", "dense_us", "dense_bytes")),
    "sumfact_roofline": (["2", "--n1", "3", "--target-s", "0.01",
                          "--rounds", "1"], ("P0_us", "P1_us", "P2_us")),
    "dss_gather_opt": (["2", "3", "--n1", "3", "--target-s", "0.01",
                        "--rounds", "1"], ("row_gather_us",
                                           "cm_trailing_us")),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_runs_and_agrees_on_the_cpu(name, capsys):
    """Each measurement driver end to end on the CPU: its agreement check
    passes (fused against unfused, sumfact against dense, the two gather
    DSS forms) and its result holds its times."""
    argv, keys = DRIVERS[name]
    mod = importlib.import_module(f"pynama_tpu_torch.exp.{name}")
    out = mod.main(argv + ["--device", "cpu"])
    assert out["device"] == "cpu"
    for k in keys:
        assert out[k] > 0, (k, out)
    if "agree_err" in out:
        assert out["agree_err"] <= 1e-5
    if name == "fused_ab":
        # the agreement check, 3 warm + 3 sizing applies, 1 round of 3 + 6
        assert out["k1_applications"] == 1 + 3 + 3 + 3 + 6
    if name == "ngl7_blocks":
        # the agreement check, a warm chain of 3, 1 round of 3
        assert out["k1_applications"] == 1 + 3 + 3
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")


@pytest.mark.parametrize("name", NEW)
def test_driver_defaults_to_cuda_and_raises_without_a_card(name):
    mod = importlib.import_module(f"pynama_tpu_torch.exp.{name}")
    with pytest.raises(RuntimeError, match="is_available"):
        mod.main([])


def test_no_jax_walk_covers_the_new_modules():
    """tests/test_torch_setup.py::test_port_never_imports_jax imports every
    module pkgutil.walk_packages finds in the port: the eight new drivers
    are among them."""
    names = {m.name for m in pkgutil.walk_packages(
        pynama_tpu_torch.__path__, "pynama_tpu_torch.")}
    assert {f"pynama_tpu_torch.exp.{n}" for n in NEW} <= names
