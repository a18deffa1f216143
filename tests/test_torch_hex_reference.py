"""The port's `Problem` on a distorted gmsh hex mesh against the benchmark's
plain reference of that case (`benchmark/reference/hexes.py`), the way the
benchmark's tg3d.gmsh cell compares them: the configuration
`taylor-green3d-hex25-ngl3` cut to 3^3 hexes, the program module
`programs/gmsh_problem.py` (the mesh written by `meshes/hex_cube.py` and
read back through the port's gmsh reader, the engine's CG with the
sum-factorized or the dense K, the gather DSS), two accepted steps from a
seeded `tg3d_perturbed` start, the reference marched to the port's final
time, the fields compared in the canonical node order.

Tolerances (relative L2 gaps, float64 on the CPU): the reference solves
its KLE systems with the f64 Cholesky factor (1,029 dofs), the port with
CG at rtol 1e-12, so the velocity gap sits near the CG's stop (3.5e-12
measured) and the vorticity's, which the velocity moves only through
two steps of dt ~ 1e-3 to 1e-2, lower (1.3e-13); VEL_TOL and VORT_TOL
leave about 30x above those. The same run in float32 (the cell's own
precision and CG rtol 1e-6) reads 1.9e-6 and 1.7e-7, four orders above.

Tests marked `card` run the port on an NVIDIA card against the reference
on the CPU, and skip without one.
"""
import dataclasses
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import check  # noqa: E402
from harness.spec import Cell  # noqa: E402
from meshes import hex_cube  # noqa: E402

torch.set_num_threads(1)

VEL_TOL = 1e-10
VORT_TOL = 5e-12
SEED = 2**31 + 17
CONFIG = os.path.join(BENCH, "configs", "taylor-green3d-hex25-ngl3.json")
MIX = os.path.join(BENCH, "traffic", "cg-sumfact-tg3d-2steps.json")


def cell(nelem=3, precision="float64", sumfact=True):
    """The tg3d.gmsh cell cut to nelem^3 hexes; in float64 the port's CG
    stops at rtol 1e-12, in float32 at the mix's own 1e-6."""
    cfg = json.load(open(CONFIG))
    cfg["case"]["domain"]["hex-cube"]["nelem"] = [nelem] * 3
    cfg["precision"] = precision
    mix = json.load(open(MIX))
    mix["sumfact"] = sumfact
    if precision == "float64":
        mix["cg_rtol"] = 1e-12
    return Cell(name="tg3d.gmsh", chips=1, config=cfg, mix=mix,
                limits={"vort_rel": VORT_TOL, "vel_rel": VEL_TOL},
                end_to_end=[], per_layer=[], bench_dir=BENCH)


def replay(c, device="cpu"):
    """(the program, its answer) of one replay of the segment."""
    prog = c.piece("program").Program(c, device)
    prog.load(*check.start_state(c, prog.coords, SEED))
    return prog, prog.replay()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("sumfact", [True, False])
def test_port_matches_the_reference_in_f64(sumfact):
    c = cell(sumfact=sumfact)
    prog, ans = replay(c)
    ops = prog.problem.engine_ops
    assert prog.problem.solver_method == "cg" and not ops.lay_v.structured
    assert (ops.sumfact is not None) == sumfact
    assert ans[1] == 2 and ans[2].shape == (7 ** 3, 3)
    v = check.judge(c, [ans], SEED, "cpu", log=lambda m: None)
    assert v["compared"] == 1 and v["failed"] == 0, v["numbers"]
    assert v["numbers"]["vel_rel"] <= VEL_TOL
    assert v["numbers"]["vort_rel"] <= VORT_TOL


def test_f32_fails_the_f64_tolerances():
    c = cell(precision="float32")
    _, ans = replay(c)
    v = check.judge(c, [ans], SEED, "cpu", log=lambda m: None)
    assert ans[1] == 2
    assert v["numbers"]["vel_rel"] > 100 * VEL_TOL
    assert v["numbers"]["vort_rel"] > 100 * VORT_TOL
    assert v["failed"] == 1


def test_both_sides_share_the_canonical_nodes():
    """The program's nodes (the port's gmsh reader and numbering) sorted
    are the reference's (its own lattice and trilinear maps) sorted."""
    c = cell(nelem=2)
    prog = c.piece("program").Program(c, "cpu")
    ref = check.reference_case(c, "cpu")
    assert prog.coords.shape == ref.coords.shape == (125, 3)
    np.testing.assert_allclose(prog.coords, ref.coords, rtol=0, atol=1e-14)
    order = hex_cube.canonical_order(prog.coords)
    np.testing.assert_array_equal(order, np.arange(125))


def test_reference_walls_are_taylor_green3d():
    """At t > 0 the reference's wall values are the port's `taylor_green3d`
    library at alpha(t), on every boundary node and nowhere else."""
    from pynama_tpu_torch.functions import get_function_lib
    c = cell(nelem=2)
    ref = check.reference_case(c, "cpu")
    lib = get_function_lib("taylor_green3d")
    t = 0.37
    ref._t = t
    a = lib.alpha(ref.nu, t)
    xyz = ref._xyz
    wall = ref.wall.numpy()
    on_box = np.any((np.abs(xyz.numpy()) < 1e-12)
                    | (np.abs(xyz.numpy() - 1) < 1e-12), axis=1)
    np.testing.assert_array_equal(wall, on_box)
    for got, want in ((ref.vel_vals, lib.velocity(xyz, a)),
                      (ref.vort_vals, lib.vorticity(xyz, a))):
        np.testing.assert_allclose(got[ref.wall], want[ref.wall],
                                   rtol=0, atol=1e-13)
        assert not got[~ref.wall].any()


@pytest.mark.parametrize("nelem,distort", [((25, 25, 25), 0.12),
                                           ((3, 4, 5), 0.3)])
def test_hex_cube_writes_the_bench_mesh(tmp_path, nelem, distort):
    """hex_cube's file is write_hex_msh's byte for byte, and the corners it
    hands the reference are the file's vertices."""
    from pynama_tpu_torch.exp import write_hex_msh
    from pynama_tpu_torch.mesh.gmsh import read_msh
    a = hex_cube.write_msh(str(tmp_path / "a.msh"), nelem, distort)
    b = write_hex_msh(str(tmp_path / "b.msh"), *nelem, distort)
    assert filecmp.cmp(a, b, shallow=False)
    verts = read_msh(a).vertices
    np.testing.assert_array_equal(
        verts, hex_cube.vertices(nelem, distort).reshape(-1, 3))
    nx, ny, nz = nelem
    v = verts.reshape(nx + 1, ny + 1, nz + 1, 3)
    corners = hex_cube.corners(nelem, distort)
    np.testing.assert_array_equal(corners[0], v[:2, :2, :2].reshape(8, 3))
    np.testing.assert_array_equal(corners[-1], v[-2:, -2:, -2:]
                                  .reshape(8, 3))


def test_reference_loads_nothing_of_the_port():
    code = (
        "import json, sys\n"
        "from reference.hexes import Case\n"
        f"c = json.load(open({CONFIG!r}))['case']\n"
        "c['domain']['hex-cube']['nelem'] = [2, 2, 2]\n"
        "Case(c, device='cpu')\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH":
                              os.pathsep.join([ROOT, BENCH])})
    assert out.returncode == 0, out.stderr[-2000:]
    mods = set(out.stdout.split())
    assert "torch" in mods
    assert not mods & {"pynama_tpu_torch", "pynama_tpu", "jax", "jaxlib"}


def test_start_refuses_another_case():
    c = cell(nelem=2)
    case = dict(c.case, **{"initial-conditions": {"vorticity": [0, 0, 0]}})
    with pytest.raises(ValueError, match="taylor_green3d"):
        c.piece("start").build(case, np.zeros((4, 3)), c.mix, 1)
    with pytest.raises(ValueError, match="at rest"):
        check.start_state(dataclasses.replace(
            c, config=dict(c.config, start="modes_at_rest")),
            np.zeros((4, 3)), 1)


@pytest.mark.card
def test_card_port_matches_the_reference_in_f64(card):
    """The port on the card (the fused CG epilogue's f64 kernels, the
    sumfact K and the gather DSS on the device) against the reference on
    the CPU, at the CPU test's tolerances."""
    c = cell()
    _, ans = replay(c, card)
    v = check.judge(c, [ans], SEED, "cpu", log=lambda m: None)
    assert v["failed"] == 0, v["numbers"]
