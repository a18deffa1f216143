"""The Re=100 cavity validation driver of the port
(pynama_tpu_torch/exp/cavity_re100.py) against the JAX package's
(exp/cavity_re100.py, loaded by path), float64 on the CPU, and the port's
committed artifacts, marches on the card, against the JAX package's: the
50x50 ngl=3 production mesh in float32 (cavity_re100_h100.json, as far as
its run got) against the JAX package's march of it on the CPU and against
the TPU artifact (exp/cavity_re100_fine.json) at their common checkpoints;
tests/test_cavity_re100.py's coarse march to t=10 in float64
(cavity_re100_coarse_h100.json) against the JAX package's on the CPU and
against the TPU artifact's t=10 snapshot; the production artifact against
Ghia, Ghia & Shin (1982) once its march is steady.
"""
import importlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pynama_tpu_torch.exp import cavity_re100 as T
from pynama_tpu_torch.mesh import BoxMesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_ART = os.path.join(ROOT, "exp", "cavity_re100_fine.json")
EXP = os.path.join(ROOT, "pynama_tpu_torch", "exp")
#: the port's artifacts, each a run of pynama_tpu_torch.exp.cavity_re100 on
#: the card: the TPU artifact's configuration (as far as the run got), and
#: tests/test_cavity_re100.py's coarse march to t=10
PORT_ARTS = {"fine": os.path.join(EXP, "cavity_re100_h100.json"),
             "coarse": os.path.join(EXP, "cavity_re100_coarse_h100.json")}
PORT_CONFIGS = {"fine": (50, 3, "float32", 1e-6),
                "coarse": (10, 4, "float64", 1e-9)}
#: the JAX package's march of the production mesh (50x50 ngl=3, CG rtol
#: 1e-6) in f64 on the CPU, at the fine artifact's first checkpoints
#: (`python tools/cavity_re100_reference.py --part jax --nelem 50 --ngl 3
#: --cg-rtol 1e-6 --checkpoints 0.5 1 ... --out <this file>`)
FINE_JAX = os.path.join(ROOT, "tests", "cavity_re100_jax_50x50.json")

#: Ghia, Ghia & Shin (JCP 1982), Re=100, 129x129 grid: u on the vertical
#: centerline. u_min = -0.21090 at y = 0.4531; u(y=0.5) = -0.20581.
GHIA_U_MIN = -0.21090
GHIA_Y_AT_U_MIN = 0.4531
GHIA_U_MID = -0.20581
#: the largest change of a normalized centerline profile that counts as
#: steady: the bound tests/test_cavity_re100.py puts on two checkpoints of
#: one run; here also the bound on the port's profiles against the TPU's
#: at a common checkpoint
STEADY_DRIFT = 0.004
#: port against JAX package, float64 on the CPU, CG rtol 1e-10: relative
#: to each profile's max-norm
MARCH_RTOL = 1e-8
PROFILES = ("u_centerline", "v_centerline")
#: tests/test_cavity_re100.py's tolerances on the coarse march against the
#: TPU artifact's t=10 snapshot (relative L2)
COARSE_TOL = {"u_centerline": 0.08, "v_centerline": 0.20}
#: the JAX package's coarse march (10x10 ngl=4, CG rtol 1e-9) to t=10, f64
#: on the CPU (`python tools/cavity_re100_reference.py --part jax
#: --checkpoints 10`, 112 s): its accepted steps and centerline profiles,
#: normalized by the lid velocity, at the coarse mesh's nodes (31 each)
COARSE_JAX = {
    "steps": 284,
    "u_centerline": [0.0, -0.015293188942176418, -0.03555901006174757,
        -0.04835453958085041, -0.05717492829882696, -0.07578922372833542,
        -0.0823982804150607, -0.09704203236940455, -0.11031421733094104,
        -0.12650435151780687, -0.12977764619208773, -0.1490116589564366,
        -0.14945596501598798, -0.16314200073838128, -0.16469827234223633,
        -0.17154294884684357, -0.1633568720541014, -0.1543792457739459,
        -0.139749826229466, -0.12432403580218163, -0.09050900139289775,
        -0.05972245044050234, -0.03402445615805432, 0.032997899849807805,
        0.07124151436406713, 0.1398951616264149, 0.2645557007737617,
        0.38718672560455175, 0.5153892894973993, 0.8021370510499863, 1.0],
    "v_centerline": [0.0, 0.043641478177736004, 0.08609453121867959,
        0.1233944074634502, 0.12164796011601406, 0.15069948260243715,
        0.1346609963365662, 0.15718389213560963, 0.14166311145010488,
        0.15644462301466544, 0.13260905833598144, 0.12846056844485748,
        0.10364481197554731, 0.10265119572404768, 0.07176333064610767,
        0.06213665253586244, 0.035491373243096876, 0.002755136934231432,
        -0.02619466986857233, -0.04769717964981964, -0.091535707723685,
        -0.11314133492527496, -0.1393174961383301, -0.16495547476078865,
        -0.17843208926671175, -0.17574491822663937, -0.1614296270601948,
        -0.1356903279090887, -0.10561428118672075, -0.04391517372884836, 0.0],
}
#: The card's f64 march sums in another order than the CPU's, and its CG
#: stops at other iterates within rtol 1e-9. Two CPU runs that differ only
#: so, the port against the JAX package (`python
#: tools/cavity_re100_reference.py --part both --checkpoints 10`, one
#: thread, 23 min), took the same 284 steps, and their profiles differ by
#: 5.1e-11 (u) and 3.6e-10 (v) of their max-norms; the limit keeps ~100x
#: over that, far below the stepper's tolerance (3e-4), the scale at which
#: another step sequence shows
COARSE_JAX_LIMIT = 4e-8
COARSE_STEP_SLACK = 0


def jax_module():
    spec = importlib.util.spec_from_file_location(
        "jax_cavity_re100", os.path.join(ROOT, "exp", "cavity_re100.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_arts():
    return {name: load(path) for name, path in PORT_ARTS.items()}


@pytest.fixture(scope="module")
def tpu_art():
    return load(TPU_ART)


@pytest.mark.parametrize("args", [(50, 3, 80.0), (10, 4, 10.0),
                                  (6, 4, 0.4, 17)])
def test_cavity_cfg_matches_jax(args):
    assert T.cavity_cfg(*args) == jax_module().cavity_cfg(*args)
    assert (T.U_LID, T.RHO) == (jax_module().U_LID, jax_module().RHO)


def test_checkpoints_are_the_jax_drivers():
    """10, 20, every 20 from 30, and t_end (exp/cavity_re100.py main)."""
    assert T.checkpoints_for(80.0) == [10.0, 20.0, 30.0, 50.0, 70.0, 80.0]
    assert T.checkpoints_for(30.0) == [10.0, 20.0, 30.0]
    assert T.checkpoints_for(5.0) == [5.0]


def test_short_march_matches_jax():
    """6x6 ngl=4 through both packages' march_segments to checkpoints
    0.2 and 0.4: the same accepted steps and end time, and every
    snapshot's centerline profiles within MARCH_RTOL."""
    from pynama_tpu.cases import Problem as JProblem
    from pynama_tpu_torch.cases import Problem as TProblem

    J = jax_module()
    cps = [0.2, 0.4]
    pj = JProblem(J.cavity_cfg(6, 4, 0.4), solver="cg", cg_rtol=1e-10,
                  cg_maxiter=4000)
    pj.setUp()
    tj, sj, _, snj = J.march_segments(pj, cps)
    pt = TProblem(T.cavity_cfg(6, 4, 0.4), device="cpu", dtype=torch.float64,
                  solver="cg", cg_rtol=1e-10, cg_maxiter=4000)
    pt.setUp()
    seen = []
    tt, st, _, snt = T.march_segments(
        pt, cps, on_snapshot=lambda t, n, s, snaps: seen.append((t, n)))
    assert st == sj and st > 5 and tt == pytest.approx(tj, abs=1e-12)
    assert sorted(snt) == sorted(snj) == cps
    assert [t for t, _ in seen] == pytest.approx(cps, abs=1e-12)
    assert seen[-1][1] == st
    for t in cps:
        a, b = snt[t], snj[t]
        assert a["x"] == b["x"] and a["y"] == b["y"]
        for key in PROFILES:
            ref = np.asarray(b[key])
            gap = np.abs(np.asarray(a[key]) - ref).max() / np.abs(ref).max()
            assert gap <= MARCH_RTOL, (t, key, gap)


@pytest.mark.parametrize("name", sorted(PORT_ARTS))
def test_port_artifact_config(port_arts, name):
    """Each artifact is the configuration it is named for, run on a card
    that it names with its power limit, with K1 launched once per
    operator application; its case string states the real config (Re =
    0.5 * 2 * 1 / 0.01), and its last snapshot is the state it ends on."""
    art = port_arts[name]
    c = art["config"]
    assert (c["nelem"], c["ngl"], c["dtype"], c["cg_rtol"]) == \
        PORT_CONFIGS[name]
    assert c["device"].startswith("NVIDIA") and " W" in c["nvidia_smi"]
    assert c["steps"] > 0 and c["k1_launches"] == c["k1_applications"] > 0
    assert "rho=0.5, mu=0.01, U_lid=2.0, L=1" in art["case"]
    last = max(art["snapshots"], key=float)
    assert float(last) == pytest.approx(c["t_reached"], abs=1e-6)
    for key in ("x", "y") + PROFILES:
        assert art[key] == art["snapshots"][last][key]


def test_port_artifact_matches_ghia(port_arts):
    """tests/test_cavity_re100.py's Ghia bands, on the production-mesh
    artifact once its march is steady (t >= 70, where the JAX test holds
    the TPU's artifact to them). Ghia's is a steady profile: the coarse
    march (and the JAX package's own, u_min -0.1715 at t=10) and a march
    stopped earlier are transients."""
    art = port_arts["fine"]
    t = art["config"]["t_reached"]
    if t < 70.0:
        pytest.skip(f"the card's 50x50 march stopped at t={t:.2f}, short of "
                    "a steady state (ROADMAP Queue C: the long cavity march)")
    s = art["summary"]
    assert -0.225 < s["u_min"] < -0.172, s["u_min"]
    assert abs(s["u_min"] - GHIA_U_MIN) < 0.035, s["u_min"]
    assert abs(s["u_mid"] - GHIA_U_MID) < 0.055, s["u_mid"]
    assert abs(s["y_at_u_min"] - GHIA_Y_AT_U_MIN) < 0.09, s["y_at_u_min"]
    # secondary-vortex structure: v changes sign along y=0.5 with the
    # correct orientation (positive near the left wall, negative right)
    assert s["v_max"] > 0.1 and s["x_at_v_max"] < 0.5
    assert s["v_min"] < -0.1 and s["x_at_v_min"] > 0.5


def tpu_gaps(art, tpu_art):
    """{time: {profile: gap}} at every checkpoint both artifacts hold: on
    the TPU artifact's own mesh the max |difference| node by node; on
    another mesh tests/test_cavity_re100.py's relative L2 after
    interpolating the TPU's profile onto the port's nodes."""
    tpu = {round(float(k), 6): v for k, v in tpu_art["snapshots"].items()}
    same = (art["config"]["nelem"], art["config"]["ngl"]) == (
        tpu_art["config"]["nelem"], tpu_art["config"]["ngl"])
    out = {}
    for k, a in art["snapshots"].items():
        b = tpu.get(round(float(k), 6))
        if b is None:
            continue
        out[k] = {}
        for key, axis in zip(PROFILES, ("y", "x")):
            got = np.asarray(a[key])
            if same:
                assert np.allclose(a[axis], b[axis], rtol=0, atol=1e-12)
                out[k][key] = float(np.abs(got - np.asarray(b[key])).max())
            else:
                ref = np.interp(a[axis], b[axis], b[key])
                out[k][key] = float(np.linalg.norm(got - ref)
                                    / np.linalg.norm(ref))
    return out, same


def test_port_artifacts_match_tpu_artifact(port_arts, tpu_art):
    """At every checkpoint an artifact of the port shares with the TPU
    artifact: on the same 50x50 ngl=3 mesh, each normalized centerline
    profile within STEADY_DRIFT node by node; on the coarse mesh, within
    tests/test_cavity_re100.py's coarse-against-fine tolerances
    (COARSE_TOL). At least one checkpoint is compared."""
    compared = 0
    for name, art in port_arts.items():
        gaps, same = tpu_gaps(art, tpu_art)
        for k, g in gaps.items():
            for key, gap in g.items():
                tol = STEADY_DRIFT if same else COARSE_TOL[key]
                assert gap <= tol, (name, k, key, gap, tol)
                compared += 1
    assert compared > 0


def test_coarse_artifact_matches_jax_march(port_arts):
    """The card's f64 coarse march to t=10 against the JAX package's own,
    f64 on the CPU: the accepted steps within COARSE_STEP_SLACK, the
    profiles within COARSE_JAX_LIMIT of their max-norm."""
    art = port_arts["coarse"]
    c = art["config"]
    assert c["t_reached"] == pytest.approx(10.0, abs=1e-9)
    assert abs(c["steps"] - COARSE_JAX["steps"]) <= COARSE_STEP_SLACK
    snap = art["snapshots"][max(art["snapshots"], key=float)]
    mesh = BoxMesh.create(4, (10, 10), [0, 0], [1, 1])
    for key, axis, line in zip(PROFILES, ("y", "x"), ("x", "y")):
        assert np.array_equal(snap[axis], mesh.nodes_over_line(line, 0.5)[1])
        ref = np.asarray(COARSE_JAX[key])
        gap = np.abs(np.asarray(snap[key]) - ref).max() / np.abs(ref).max()
        assert gap <= COARSE_JAX_LIMIT, (key, gap)


def test_fine_artifact_matches_jax_march(port_arts):
    """The card's f32 march of the production mesh against the JAX
    package's f64 march of it on the CPU (FINE_JAX, the same checkpoints),
    at every checkpoint both reached: each normalized centerline profile
    within STEADY_DRIFT node by node."""
    art, ref = port_arts["fine"], load(FINE_JAX)
    assert ref["config"]["checkpoints"] == \
        art["config"]["checkpoints"][:len(ref["config"]["checkpoints"])]
    common = sorted(set(art["snapshots"]) & set(ref["snapshots"]), key=float)
    assert common, (sorted(art["snapshots"]), sorted(ref["snapshots"]))
    for k in common:
        a, b = art["snapshots"][k], ref["snapshots"][k]
        for key, axis in zip(PROFILES, ("y", "x")):
            assert a[axis] == b[axis]
            gap = np.abs(np.asarray(a[key]) - np.asarray(b[key])).max()
            assert gap <= STEADY_DRIFT, (k, key, gap)


@pytest.mark.parametrize("name", sorted(PORT_ARTS))
def test_port_artifact_is_steady_when_it_got_there(port_arts, name):
    """If a run reached t >= 70, its last two checkpoints meet the
    steadiness bound tests/test_cavity_re100.py holds the TPU's to; every
    checkpoint it took is finite and holds the wall values (0 at rest, 1
    at the lid)."""
    art = port_arts[name]
    keys = sorted(art["snapshots"], key=float)
    for k in keys:
        s = art["snapshots"][k]
        u, v = np.asarray(s["u_centerline"]), np.asarray(s["v_centerline"])
        assert np.isfinite(u).all() and np.isfinite(v).all()
        assert u[0] == 0.0 and u[-1] == pytest.approx(1.0, abs=1e-6)
        assert v[0] == 0.0 and v[-1] == 0.0
    if float(keys[-1]) >= 70.0:
        a, b = (art["snapshots"][k] for k in keys[-2:])
        for key in PROFILES:
            drift = np.abs(np.asarray(b[key]) - np.asarray(a[key])).max()
            assert drift < STEADY_DRIFT, (keys[-2:], key, drift)


@pytest.mark.parametrize("name,argv", [
    ("cavity_re100", ["4", "3", "0.01"]),
    ("ibm_cd", ["0.01", "--nelem", "4"])])
def test_drivers_default_to_cuda(name, argv, tmp_path):
    """Both validation drivers run on the card unless asked for the CPU:
    without a card the default raises before any work or output."""
    mod = importlib.import_module(f"pynama_tpu_torch.exp.{name}")
    assert mod.parse_args([]).device == "cuda"
    assert mod.parse_args([]).dtype == torch.float32
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(argv[:3] + [str(out)] if name == "cavity_re100"
                 else [argv[0], str(out)] + argv[1:])
    assert not out.exists()
