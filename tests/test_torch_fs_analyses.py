"""The port's FS-stage analyses (pynama_tpu_torch/exp/fs_spectrum.py,
fs_walls.py, fs_woodbury.py) against the JAX package's (exp/fs_*.py,
imported as `exp.*` from the repo root), float64 on the CPU at 2^3 ngl=4
(1,029 dofs: the smallest box where every variant of the three builds;
the localization at 3^3, where one element layer is not the whole box).

The JAX numbers are recorded at full precision by tools/fs_reference.py
(its `jax_spectrum`, `jax_walls`, `jax_woodbury`: the eigenvalues the JAX
`analyze` computes, made into records by the port's arithmetic). Limits:
the assembled matrices are the same host numpy sums (1e-13 relative); the
dense FDM inverse differs only in the order of the FDM apply's
contractions (1e-12 relative); every spectral float within GAP_LIMIT,
chip_smoke.py's FS_LIMIT (~100x the 1.0e-12 / 1.8e-12 / 9.4e-13 that two
CPU runs differing only in summation order showed at 3^3 / 4^3 / walls
2^3); census and CG counts equal (no eigenvalue lies within the limit of
a census threshold here: the records' margins are >= 4.5e-5).
"""
import contextlib
import importlib
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from pynama_tpu_torch.exp import fs_spectrum as PS
from pynama_tpu_torch.exp import fs_walls as PW
from pynama_tpu_torch.exp import fs_woodbury as PB

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU, F64 = torch.device("cpu"), torch.float64
NE, NGL = 2, 4
GAP_LIMIT = 2e-10
#: the woodbury CG counts' spread under summation order alone (see
#: test_fs_woodbury_iteration_counts_match)
G_ITER_SLACK = 2
K_ITER_SLACK = 3


def _tool():
    spec = importlib.util.spec_from_file_location(
        "fs_reference", os.path.join(ROOT, "tools", "fs_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def jax_mods():
    return {n: TOOL.jax_module(n)
            for n in ("fs_spectrum", "fs_walls", "fs_woodbury")}


@pytest.fixture(scope="module")
def problems(jax_mods):
    from pynama_tpu.cases import Problem as JaxProblem
    pj = JaxProblem(jax_mods["fs_spectrum"].cavity_cfg(NE, NGL),
                    solver="cg", engine=False)
    pj.setUp()
    return pj, PS.problem(NE, NGL, CPU, F64)


def _both(tool_fn, analysis, ne):
    """(JAX record, JAX printed text, port record, port printed text)."""
    fj, fp = io.StringIO(), io.StringIO()
    rj = tool_fn(ne, stdout=fj)
    rp = TOOL.port(analysis, ne, stdout=fp)
    return rj, fj.getvalue(), rp, fp.getvalue()


@pytest.fixture(scope="module")
def spectrum_runs(jax_mods):
    return _both(TOOL.jax_spectrum, PS, NE)


@pytest.fixture(scope="module")
def walls_runs(jax_mods):
    return _both(TOOL.jax_walls, PW, NE)


@pytest.fixture(scope="module")
def woodbury_runs(jax_mods):
    return _both(TOOL.jax_woodbury, PB, NE)


def _printed(text):
    """Printed lines without the K = S + B^T B line (its round-off) and
    the CG counts' lines (summation order moves them by a few iterations:
    test_fs_woodbury_iteration_counts_match)."""
    return [ln for ln in text.splitlines()
            if not any(w in ln for w in ("rel err", "iters", "block("))]


def test_cavity_cfg_equal(jax_mods):
    """(a) The analyses' cavity config is the JAX one."""
    for ne, ngl in ((2, 4), (5, 3)):
        assert PS.cavity_cfg(ne, ngl) == \
            jax_mods["fs_spectrum"].cavity_cfg(ne, ngl)


@pytest.mark.parametrize("which", ["K", "S"])
def test_assembled_matrices_match(jax_mods, problems, which):
    """(b) assemble_global_K and assemble_S within 1e-13 relative."""
    pj, pp = problems
    if which == "K":
        a, b = PS.assemble_global_K(pp), \
            jax_mods["fs_spectrum"].assemble_global_K(pj)
    else:
        a, b = PB.assemble_S(pp), jax_mods["fs_woodbury"].assemble_S(pj)
    assert a.shape == b.shape == (1029, 1029)
    assert _rel(a, b) <= 1e-13


@pytest.mark.parametrize("mask", ["free_fs", "free_main", "slab"])
def test_fdm_minv_dense_matches(jax_mods, problems, mask):
    """(c) The dense FDM inverse within 1e-12 relative, for both stages'
    masks and one slab mask of fs_walls (the first face's slab at
    thickness ngl-1)."""
    pj, pp = problems
    free = np.asarray(pp.bc.free_fs if mask == "slab"
                      else getattr(pp.bc, mask), dtype=bool).reshape(-1)
    if mask == "slab":
        npts = tuple(pp.mesh.npts)
        g = np.zeros(npts, dtype=bool)
        g[:NGL] = True
        free = free & np.repeat(g.reshape(-1), 3)
    free = free.astype(np.float64)
    mp = PS.fdm_minv_dense(pp, free)
    mj = jax_mods["fs_spectrum"].fdm_minv_dense(pj, free)
    assert mp is not None and mj is not None
    assert mp.dtype == F64 and tuple(mp.shape) == mj.shape
    assert _rel(mp.numpy(), mj) <= 1e-12


def test_fs_spectrum_numbers_match(spectrum_runs):
    """(d) Every number fs_spectrum.analyze returns: kappas, k-drop tables
    and extremes within GAP_LIMIT, free dofs and census counts equal."""
    rj, _, rp, _ = spectrum_runs
    assert rp["n_dofs"] == 1029
    gap, differ = PS.record_gap({k: rp[k] for k in ("FS", "MAIN")}, rj)
    assert differ == []
    assert gap <= GAP_LIMIT
    assert min(rj[s][pc]["margin"] for s in rj for pc in rj[s]
               if pc != "free") > GAP_LIMIT


@pytest.mark.parametrize("analysis", ["spectrum", "walls", "woodbury"])
def test_printed_lines_are_the_jax_scripts(spectrum_runs, walls_runs,
                                           woodbury_runs, analysis):
    """Each analysis prints the JAX script's lines, digit for digit (all
    but the K = S + B^T B check's round-off and the CG counts)."""
    runs = {"spectrum": spectrum_runs, "walls": walls_runs,
            "woodbury": woodbury_runs}[analysis]
    _, tj, _, tp = runs
    assert _printed(tj) and _printed(tp) == _printed(tj)


def test_wall_dof_sets_equal(jax_mods, problems):
    """(e) The wall and wall+1-layer masks are the JAX ones."""
    pj, pp = problems
    idx = np.where(np.asarray(pp.bc.free_fs, dtype=bool).reshape(-1))[0]
    mp = PW.wall_dof_sets(pp, idx)
    mj = jax_mods["fs_walls"].wall_dof_sets(pj, idx)
    assert mp.keys() == mj.keys() == {"ww", "ww1"}
    for k in mp:
        assert np.array_equal(mp[k], mj[k])


def test_fs_walls_variants_match(walls_runs):
    """(e) Every one of the 15 fs_walls variants: kappa (and extremes)
    within GAP_LIMIT."""
    rj, _, rp, _ = walls_runs
    assert len(rp["variants"]) == 15
    gap, differ = PS.record_gap({"variants": rp["variants"]}, rj)
    assert differ == []
    assert gap <= GAP_LIMIT


def test_build_B_and_woodbury_identity(jax_mods, problems):
    """(f) build_B within 1e-12 of the JAX one; K = S + B^T B to 1e-13."""
    pj, pp = problems
    bp, bj = PB.build_B(pp), jax_mods["fs_woodbury"].build_B(pj)
    assert bp.shape == bj.shape == (8 * 108, 1029)
    assert _rel(bp, bj) <= 1e-12
    K, S = PS.assemble_global_K(pp), PB.assemble_S(pp)
    assert np.abs(K - (S + bp.T @ bp)).max() / np.abs(K).max() <= 1e-13


def test_fs_woodbury_iteration_counts_match(woodbury_runs):
    """(f) pcg_dense and the block preconditioners take the JAX package's
    CG iteration counts, within what summation order alone moves them
    (chip_smoke.py's FS_ITER_SLACK on the G counts: the JAX package alone
    takes 212 or 214 at 3^3 with 1 or 2 BLAS threads; K/jacobi 258 or 261
    at 2^3 between the pair, K_ITER_SLACK); the K check holds to 1e-13."""
    rj, _, rp, _ = woodbury_runs
    assert rp["iters"].keys() == rj["iters"].keys()
    for k, n in rj["iters"].items():
        slack = G_ITER_SLACK if k.startswith("G/") else K_ITER_SLACK
        assert abs(rp["iters"][k] - n) <= slack, (k, rp["iters"], n)
    assert rp["k_check"] <= 1e-13


def test_pcg_dense_is_pcg_np(jax_mods):
    """pcg_dense keeps pcg_np's semantics: the same iterate and count on a
    random SPD system, with and without a preconditioner, and 0 iterations
    for a zero right-hand side."""
    rng = np.random.default_rng(3)
    Q = rng.standard_normal((40, 40))
    A = Q @ Q.T + 40 * np.eye(40)
    b = rng.standard_normal(40)
    d = np.diag(A).copy()
    jx = jax_mods["fs_woodbury"].pcg_np
    for pre in (None, "jacobi"):
        xj, kj = jx(A, b, Minv=None if pre is None else (lambda r: r / d))
        At, bt, dt = (torch.as_tensor(a) for a in (A, b, d))
        xp, kp = PB.pcg_dense(At, bt, Minv=None if pre is None
                              else (lambda r: r / dt))
        assert kp == kj > 0
        assert np.abs(xp.numpy() - xj).max() <= 1e-12 * np.abs(xj).max()
    assert PB.pcg_dense(At, torch.zeros(40, dtype=F64))[1] == 0


def _cluster_wall_mass(lam, W, wall, nlow):
    """Wall mass of the nlow lowest modes, summed over each cluster of
    eigenvalues closer than 1e-6 relative (numerator and denominator are
    traces over the cluster's eigenspace, so they do not depend on the
    basis a solver picks in it); a cluster cut by nlow is dropped."""
    lam = np.sort(np.asarray(lam))[:nlow + 1]
    W = np.asarray(W)
    num = (W[wall] ** 2).sum(0)
    den = (W ** 2).sum(0)
    starts = [0] + [i for i in range(1, nlow + 1)
                    if lam[i] - lam[i - 1] > 1e-6 * abs(lam[i])]
    ends = starts[1:] + [nlow + 1]
    return np.asarray([num[a:b].sum() / den[a:b].sum()
                       for a, b in zip(starts, ends) if b <= nlow])


def test_localization_same_fractions(jax_mods):
    """(g) localization at 3^3 (FDM-preconditioned FS operator, the 128
    lowest modes): the same printed summary and the same wall fractions,
    per mode where the eigenvalue is simple and per cluster where it is
    not, within 1e-9."""
    from pynama_tpu.cases import Problem as JaxProblem
    J = jax_mods["fs_spectrum"]
    pj = JaxProblem(J.cavity_cfg(3, NGL), solver="cg", engine=False)
    pj.setUp()
    pp = PS.problem(3, NGL, CPU, F64)
    free = np.asarray(pp.bc.free_fs, dtype=np.float64)
    idx = np.where(free.reshape(-1) > 0)[0]
    A = PS.assemble_global_K(pp)[np.ix_(idx, idx)]
    mi = J.fdm_minv_dense(pj, free)[np.ix_(idx, idx)]
    lamM, V = np.linalg.eigh(0.5 * (mi + mi.T))
    Sq = V * np.sqrt(np.maximum(lamM, 1e-300))[None, :]
    fj, fp = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(fj):
        lam_j, W_j = J.localization(pj, idx, A, Sq)
    with contextlib.redirect_stdout(fp):
        lam_p, W_p, frac_p = PS.localization(pp, idx, torch.as_tensor(A),
                                             torch.as_tensor(Sq))
    assert fp.getvalue() == fj.getvalue()
    assert frac_p.shape == (128,) and 0.05 < np.median(frac_p) < 1.0
    assert _rel(lam_p, lam_j) <= GAP_LIMIT
    npts = tuple(pp.mesh.npts)
    g = np.zeros(npts, dtype=bool)
    for d in range(3):
        sl = [slice(None)] * 3
        sl[d] = slice(0, NGL)
        g[tuple(sl)] = True
        sl[d] = slice(-NGL, None)
        g[tuple(sl)] = True
    wall = np.repeat(g.reshape(-1), 3)[idx]
    cj = _cluster_wall_mass(lam_j, W_j, wall, 128)
    cp = _cluster_wall_mass(lam_p, W_p.numpy(), wall, 128)
    assert cj.size == cp.size > 64
    assert np.abs(cj - cp).max() <= 1e-9
