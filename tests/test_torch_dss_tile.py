"""The DSS pass's tile plan against the plain DSS, bit for bit.

The CUDA DSS pass (csrc/fused_common.cuh, K1's second half) stages, per CTA,
a chunk of an axis-2 element row and the neighbour planes it shares into a
shared-memory tile, adds the copies of each node in the tile one axis per
pass (axis 0, then 1, then 2), and copies y and bnd out of the tile.
`ops/fused.py` restates its plan (`dss_tile_plan`, `dss_tile_cta`,
`dss_tile_passes`). Here numpy runs that plan on the CPU: it stages u into a
NaN-filled tile run by run, checks that no entry is staged twice or is in
two pairs of one pass (the kernel's passes are race-free), runs the passes
and the copies out, and must give bitwise the y and bnd of the plain
version (`dss_ref`, the axis-by-axis `ops/local.py::dss_box`), which sums in
the canonical order. The kernel itself needs the GPU and is checked
bitwise against `dss_ref` by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynama_tpu.ops.fused import fused_apply as jax_fused_apply
from pynama_tpu_torch.ops import fused as F

torch.set_num_threads(1)

# (nelem, ngl, ncomp, chunk): chunk 0 takes the kernel's rule
CASES = [
    ((3, 4, 5), 4, 3, 0),     # 3D ngl=4, 192 columns, whole rows
    ((3, 4, 5), 4, 3, 2),     # chunked rows: halo elements of other chunks
    ((2, 3, 7), 4, 6, 3),     # 384 columns, a short last chunk
    ((2, 2, 3), 7, 3, 0),     # ngl=7, 1029 columns
    ((2, 2, 2), 7, 6, 1),     # 2058 columns, one element per chunk
    ((2, 2, 2), 2, 3, 0),     # ngl=2: every node on a face
    ((1, 3, 4), 4, 3, 0),     # ne_0 = 1: both bnd sides from one slice
    ((3, 1, 4), 4, 3, 0),     # ne_1 = 1
    ((3, 4, 1), 4, 3, 0),     # ne_2 = 1: rows of one element
    ((1, 1, 1), 3, 2, 0),
    ((3, 4), 3, 1, 0),        # 2D ngl=3, 9 columns
    ((3, 4), 3, 2, 0),        # 18
    ((3, 4), 3, 3, 2),        # 27, chunked
    ((5, 6), 3, 2, 4),
    ((1, 4), 3, 2, 0),        # 2D ne_0 = 1
    ((4, 1), 3, 1, 0),        # 2D ne_1 = 1
]
DTYPES = [np.float32, np.float64]


def _u(nelem, ngl, ncomp, dtype, seed=3):
    nn = ngl ** len(nelem)
    rng = np.random.default_rng(seed)
    return rng.standard_normal((int(np.prod(nelem)), nn * ncomp)).astype(
        dtype)


def _tile_dss(u, nelem, ngl, ncomp, chunk):
    """y and bnd of u as the kernel's plan computes them, CTA by CTA."""
    plan = F.dss_tile_plan(nelem, ngl, ncomp, u.dtype.itemsize, chunk)
    R, plane = plan["R"], plan["plane"]
    flat = u.ravel()
    y = np.full(u.size, np.nan, dtype=u.dtype)
    bnd = np.full(2 * R * plane, np.nan, dtype=u.dtype)
    written = np.zeros(y.size + bnd.size, dtype=int)
    for b in range(plan["ctas"]):
        cta = F.dss_tile_cta(plan, b)
        tile = np.full(plan["tile"], np.nan, dtype=u.dtype)
        staged = np.zeros(plan["tile"], dtype=int)
        for src, dst, n in cta["runs"]:
            tile[dst:dst + n] = flat[src:src + n]
            staged[dst:dst + n] += 1
        assert staged.max() <= 1         # no entry staged twice
        for a, c, to_a, to_c in F.dss_tile_passes(plan, cta):
            assert np.unique(np.concatenate([a, c])).size == 2 * a.size
            s = tile[a] + tile[c]
            tile[a[to_a]] = s[to_a]
            tile[c[to_c]] = s[to_c]
        for t, dst, n in cta["y_runs"]:
            y[dst:dst + n] = tile[t:t + n]
            written[dst:dst + n] += 1
        for t, dst, n in cta["bnd_runs"]:
            bnd[dst:dst + n] = tile[t:t + n]
            written[y.size + dst:y.size + dst + n] += 1
    assert (written == 1).all()          # every output written once
    return y.reshape(u.shape), bnd.reshape(2, R, plane)


def _bits(a):
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nelem,ngl,ncomp,chunk", CASES)
def test_tile_plan_gives_plain_dss_bitwise(nelem, ngl, ncomp, chunk, dtype):
    u = _u(nelem, ngl, ncomp, dtype)
    y, bnd = _tile_dss(u, nelem, ngl, ncomp, chunk)
    yr, br = F.dss_ref(torch.as_tensor(u), nelem, ngl, ncomp)
    assert np.array_equal(_bits(y), _bits(yr.numpy()))
    assert np.array_equal(_bits(bnd), _bits(br.numpy()))


ENGINE_SHAPES = [((24, 24, 24), 4, 3), ((24, 24, 24), 4, 6),
                 ((8, 8, 8), 7, 3), ((8, 8, 8), 7, 6), ((50, 50), 3, 1),
                 ((50, 50), 3, 2), ((50, 50), 3, 3), ((1, 2, 2), 3, 1),
                 ((4, 1, 2), 4, 3), ((2, 2, 2), 2, 3)]


@pytest.mark.parametrize("elem_bytes", [4, 8])
@pytest.mark.parametrize("nelem,ngl,ncomp", ENGINE_SHAPES)
def test_tile_plan_rule(nelem, ngl, ncomp, elem_bytes):
    """Chunks cover every row, tiles fit a CTA's shared memory and leave
    room for DSS_SM_THREADS threads per SM (or hold one element per chunk),
    and threads cover the columns."""
    p = F.dss_tile_plan(nelem, ngl, ncomp, elem_bytes)
    ne2 = p["ne"][2]
    assert (p["nch"] - 1) * p["C"] < ne2 <= p["nch"] * p["C"]
    resident = F.DSS_SM_SMEM // (p["tile_bytes"] + 1024) * p["threads"]
    assert resident >= F.DSS_SM_THREADS or p["C"] == 1
    assert p["tile_bytes"] <= F.DSS_MAX_TILE
    assert p["ctas"] == p["ne"][0] * p["ne"][1] * p["nch"]
    assert 64 <= p["threads"] <= F.DSS_MAX_THREADS
    assert p["threads"] % 32 == 0
    assert p["threads"] >= min(p["nnc"], F.DSS_MAX_THREADS)


def test_tile_plan_at_the_flagship():
    """24^3 ngl=4 f32: whole rows, 576 CTAs of one thread per column
    (44,928 bytes of tile at 192 columns, 89,856 at 384); f64 takes half
    rows."""
    p = F.dss_tile_plan((24, 24, 24), 4, 3, 4)
    assert (p["C"], p["nch"], p["threads"], p["tile_bytes"],
            p["copy_bytes"]) == (24, 1, 192, 44928, 16)
    p = F.dss_tile_plan((24, 24, 24), 4, 6, 4)
    assert (p["C"], p["nch"], p["threads"], p["tile_bytes"]) == (
        24, 1, 384, 89856)
    p = F.dss_tile_plan((24, 24, 24), 4, 3, 8)
    assert (p["C"], p["nch"], p["tile_bytes"]) == (12, 2, 48384)
    p = F.dss_tile_plan((24, 24, 24), 4, 6, 8)
    assert (p["C"], p["nch"], p["tile_bytes"]) == (12, 2, 96768)


@pytest.mark.parametrize("nelem,ngl,ncomp", [((3, 4, 5), 4, 3),
                                             ((3, 4), 3, 2),
                                             ((1, 2, 2), 3, 1)])
def test_dss_ref_matches_jax(nelem, ngl, ncomp):
    """dss_ref against the JAX Pallas kernel (interpret mode) applied with
    an identity element matrix, which leaves u exact."""
    u = _u(nelem, ngl, ncomp, np.float64, seed=5)
    nnc = u.shape[1]
    yj, bj = jax_fused_apply(jnp.asarray(u), jnp.eye(nnc), tuple(nelem),
                             ngl, ncomp, interpret=True)
    yt, bt = F.dss_ref(torch.as_tensor(u), nelem, ngl, ncomp)
    scale = float(np.abs(np.asarray(yj)).max())
    assert float(np.abs(yt.numpy() - np.asarray(yj)).max()) <= 1e-14 * scale
    assert float(np.abs(bt.numpy() - np.asarray(bj)).max()) <= 1e-14 * scale


def test_dss_pass_on_cpu_is_the_plain_version():
    nelem, ngl, ncomp = (2, 3, 4), 4, 3
    u = torch.as_tensor(_u(nelem, ngl, ncomp, np.float64))
    launches = F.dss_pass.launches
    y, bnd = F.dss_pass(u, nelem, ngl, ncomp)
    assert F.dss_pass.launches == launches
    yr, br = F.dss_ref(u, nelem, ngl, ncomp)
    assert torch.equal(y, yr) and torch.equal(bnd, br)
    m = torch.as_tensor(np.random.default_rng(0).standard_normal((192, 192)))
    yf, bf = F.fused_apply_ref(u, m, nelem, ngl, ncomp)
    yd, bd = F.dss_ref(u @ m, nelem, ngl, ncomp)
    assert torch.equal(yf, yd) and torch.equal(bf, bd)


def test_dss_pass_rejects_bad_inputs():
    u = torch.as_tensor(_u((2, 3), 3, 2, np.float64))
    with pytest.raises(TypeError):
        F.dss_pass(u.to(torch.float16), (2, 3), 3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        F.dss_pass(u[:-1], (2, 3), 3, 2)                  # wrong E
    with pytest.raises(ValueError, match="contiguous"):
        F.dss_pass(torch.cat([u, u], 1)[:, ::2], (2, 3), 3, 2)
    with pytest.raises(ValueError):
        F.dss_pass(u, (2, 3), 1, 2)                       # ngl < 2
    with pytest.raises(ValueError, match="cpu or cuda"):
        F.dss_pass(u.to("meta"), (2, 3), 3, 2)
