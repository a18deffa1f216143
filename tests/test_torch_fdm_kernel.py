"""The FDM apply's kernel route (solver/fdm.py fdm_apply, csrc/fdm_apply.cu)
and what the CPU can check of it.

The kernels split the apply into a forward plane pass (Q2ᵀ, Q1ᵀ of each
axis-0 plane, read from each node's representative element slot), a
pencil pass (Q0ᵀ, the per-mode (c, c) block, Q0) and a backward plane pass
(Q1, Q2, the Jacobi leftover term, written to every slot of each node). On
the CPU: `fdm_apply` on a CPU tensor is bitwise the plain version and
launches nothing; a numpy model of that order, with the same index maps,
equals the plain version to rounding and writes every slot exactly once;
the argument struct mirrors the kernel's; the input check raises on what
the kernels do not take.

Tests marked `card` compare the kernels with the plain version on an
NVIDIA card, and check that the kernel library's tiles fit shared memory
for any grid; they skip without one. The file imports no JAX; on the card run
them without the JAX-loading conftest: `python -m pytest --noconftest -p
no:cacheprovider -m card tests/test_torch_fdm_kernel.py`.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from pynama_tpu_torch.cases import Problem
from pynama_tpu_torch.solver import fdm as F

torch.set_num_threads(1)

F64 = torch.float64
SYSTEMS = ("fdm_main", "fdm_fs")
_CACHE = {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def cavity(nelem, ngl):
    """The no-slip lid cavity on a box of nelem elements."""
    dim = len(nelem)
    z = [0] * dim
    walls = {"up": [1.0] + [0] * (dim - 1), "down": z, "left": z,
             "right": z}
    if dim == 3:
        walls.update(back=z, front=z)
    return {
        "name": "cav",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": list(nelem), "lower": z, "upper": [1] * dim}},
        "time-solver": {"start-time": 0, "end-time": 1, "max-steps": 10},
        "boundary-conditions": {"no-slip": walls},
        "initial-conditions": {"vorticity": [0] * (1 if dim == 2 else 3)},
    }


def setup(nelem, ngl):
    """(engine ops, consistent element-local r) of the cavity under
    pc="fdm", float64 on the CPU; r from a numpy-seeded global field."""
    key = (tuple(nelem), ngl)
    if key not in _CACHE:
        p = Problem(cavity(nelem, ngl), device="cpu", dtype=F64,
                    solver="cg", pc="fdm")
        p.setUp()
        rng = np.random.default_rng(10 * ngl + len(nelem))
        r = p.to_local(rng.standard_normal((p.mesh.n_nodes, p.dim)))
        _CACHE[key] = (p.engine_ops, r.contiguous())
    return _CACHE[key]


def moved(f, device, dtype):
    """f's tensors on `device` in `dtype`."""
    to = lambda t: t.to(device=device, dtype=dtype).contiguous()
    return dataclasses.replace(f, Qs=tuple(to(q) for q in f.Qs),
                               binv=to(f.binv), jleft=to(f.jleft))


# ------------------------------------------------------------ the model
def axis_slots(np_d, ne_d, nl_d, se, sl):
    """(representative slot offset of each index, (index, slot offset)
    pairs of every slot) along one axis, as csrc/fdm_apply.cu's rep and
    slots compute them."""
    rep, pairs = [], []
    for i in range(np_d):
        if nl_d == 1:
            e, l = 0, 0
        else:
            e = min(i // (nl_d - 1), ne_d - 1)
            l = i - e * (nl_d - 1)
        rep.append(e * se + l * sl)
        s = nl_d - 1
        if s > 0 and i % s == 0 and 0 < i < np_d - 1:
            pairs += [(i, (i // s - 1) * se + s * sl), (i, (i // s) * se)]
        else:
            pairs.append((i, rep[-1]))
    idx, off = np.array(pairs).T
    return np.array(rep), idx, off


def model(f, r, nelem, ngl):
    """fdm_apply in the kernels' order on numpy float64: (z, the number of
    times each output slot was written)."""
    np3, ne3, nl3 = F.box3(f, nelem, ngl)
    c = f.ncomp
    Q = [q.numpy() for q in f.Qs]
    if len(Q) == 2:
        Q = [Q[0], np.ones((c, 1, 1)), Q[1]]
    nn = int(np.prod(nl3))
    sl = (nl3[1] * nl3[2], nl3[2], 1)
    se = (ne3[1] * ne3[2] * nn, ne3[2] * nn, nn)
    axes = [axis_slots(np3[d], ne3[d], nl3[d], se[d], sl[d])
            for d in range(3)]
    rep = [a[0] for a in axes]
    R = r.numpy().reshape(-1, c)
    g0 = R[rep[0][:, None, None] + rep[1][None, :, None]
           + rep[2][None, None, :]]                     # (np0, np1, np2, c)
    # A: each plane, Q2ᵀ then Q1ᵀ
    g = np.stack([[Q[1][a].T @ (g0[i0, :, :, a] @ Q[2][a])
                   for i0 in range(np3[0])] for a in range(c)])
    # B: each pencil, Q0ᵀ, the per-mode block, Q0
    y = np.einsum("anm,anpq->ampq", Q[0], g)
    y = np.einsum("abmpq,bmpq->ampq", f.binv.numpy().reshape((c, c) + np3),
                  y)
    g = np.einsum("anm,ampq->anpq", Q[0], y)
    # C: each plane, Q2 then Q1, the leftover term, every slot
    z = np.stack([[Q[1][a] @ (g[a, i0] @ Q[2][a].T)
                   for i0 in range(np3[0])] for a in range(c)])
    z = z + np.moveaxis(f.jleft.numpy().reshape(np3 + (c,)), -1, 0) \
        * np.moveaxis(g0, -1, 0)
    out = np.full(R.shape, np.nan)
    count = np.zeros(R.shape[0], int)
    (i0, s0), (i1, s1), (i2, s2) = [(a[1], a[2]) for a in axes]
    slot = s0[:, None, None] + s1[None, :, None] + s2[None, None, :]
    np.add.at(count, slot.reshape(-1), 1)
    out[slot] = np.moveaxis(
        z[:, i0[:, None, None], i1[None, :, None], i2[None, None, :]], 0, -1)
    return out.reshape(r.shape), count


MODEL_CASES = [((3, 4), 3), ((2, 3, 2), 3), ((2, 2, 3), 4), ((2, 5), 2),
               ((3, 2), 6), ((1, 2, 2), 5)]


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("nelem,ngl", MODEL_CASES)
def test_model_of_the_passes_is_the_plain_version(nelem, ngl, system):
    ops, r = setup(nelem, ngl)
    f = getattr(ops, system)
    got, count = model(f, r, ops.nelem, ops.ngl)
    want = F.fdm_apply_ref(f, r, ops.nelem, ops.ngl).numpy()
    assert (count == 1).all()
    assert float(np.abs(got - want).max()) <= 1e-13 * np.abs(want).max()
    # the FS stage's corner rule leaves free dofs outside any tensor mask
    assert bool(f.jleft.ne(0).any()) == (system == "fdm_fs")


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("nelem,ngl", MODEL_CASES[:2])
def test_cpu_route_is_the_plain_version(nelem, ngl, system):
    ops, r = setup(nelem, ngl)
    f = getattr(ops, system)
    n0 = F.fdm_apply.launches
    for kw in (dict(nelem=ops.nelem, ngl=ops.ngl), {}):
        assert torch.equal(F.fdm_apply(f, r, **kw),
                           F.fdm_apply_ref(f, r, **kw))
    assert F.fdm_apply.launches == n0
    assert id(f) not in F._BLOCKS


def test_build_fdm_arrays_are_contiguous():
    """The kernels read Qs, binv and jleft as contiguous arrays."""
    ops, _ = setup((2, 3, 2), 3)
    for f in (ops.fdm_main, ops.fdm_fs):
        assert all(t.is_contiguous() for t in (f.binv, f.jleft) + f.Qs)


@pytest.mark.parametrize("bad", ["strided", "rows", "width", "dtype",
                                 "box", "not_a_tensor"])
def test_input_check_raises(bad):
    ops, r = setup((2, 3, 2), 3)
    nelem, ngl = ops.nelem, ops.ngl
    arg = {"strided": torch.cat([r, r], 1)[:, ::2],
           "rows": r[:-1].contiguous(),
           "width": r[:, :-3].contiguous(),
           "dtype": r.float(),
           "box": r,
           "not_a_tensor": r.numpy()}[bad]
    if bad == "box":
        nelem = (2, 2, 3)
    with pytest.raises((TypeError, ValueError)):
        F.check_input(ops.fdm_main, arg, nelem, ngl)
    F.check_input(ops.fdm_main, r, ops.nelem, ops.ngl)


def test_args_mirror_the_kernel_struct():
    """_Args as csrc/fdm_apply.cu's Args lays it out: nine pointers, then
    f64, c, np[3], ne[3], nl[3] and a pad."""
    a = F._Args
    assert a.stream.offset == 64 and a.f64.offset == 72 and a.c.offset == 76
    assert a.np.offset == 80 and a.ne.offset == 92 and a.nl.offset == 104
    assert a.pad.offset == 116 and ctypes.sizeof(a) == 120


@pytest.mark.card
@pytest.mark.parametrize("ne3,nl3,c", [
    ((24, 24, 24), (4, 4, 4), 3), ((2, 1, 3), (4, 1, 4), 2),
    ((48, 48, 48), (4, 4, 4), 3), ((1, 1099, 4), (2, 2, 2), 3),
    ((1099, 2, 2), (2, 2, 2), 3), ((4, 1, 1500), (3, 1, 3), 2)])
def test_plan_fits_shared_memory(card, ne3, nl3, c):
    """The kernel library's tiles (pn_fdm_plan): every pass within one
    CTA's shared memory (227 KB on an H100) in f32 and f64, and within
    74 KB (three CTAs an SM) below 300 nodes an axis; the thread tiles of
    pass C and of pass B one round of the CTA's 256 threads (4 × 4 tiles)
    where a single element or pencil does not already take more."""
    np3 = tuple(e * (n - 1) + 1 for e, n in zip(ne3, nl3))
    limit = (74 if max(np3) < 300 else 227) * 1024
    for esize in (4, 8):
        p = F.kernel_plan(np3, ne3, nl3, c, esize)
        assert max(p["smem_a"], p["smem_b"], p["smem_c"]) <= limit
        assert 1 <= p["wa"] <= np3[2] and 1 <= p["ec"] <= ne3[2]
        assert 1 <= p["pb"] <= np3[1] * np3[2]
        assert min(p["ka"], p["kb"], p["kc"]) >= 1
        rows = -(-np3[1] // 4)
        w = p["ec"] * (nl3[2] - 1) + 1
        assert p["ec"] == 1 or rows * -(-w // 4) <= 256
        rows = c * -(-np3[0] // 4)
        assert p["pb"] <= 4 or rows * -(-p["pb"] // 4) <= 256
    # the flagship in f32: whole planes and whole contractions in pass A,
    # blocks of 12 elements in pass C, 16 pencils in pass B
    p = F.kernel_plan((73, 73, 73), (24, 24, 24), (4, 4, 4), 3, 4)
    assert {k: p[k] for k in ("wa", "ka", "pb", "kb", "ec", "kc")} == dict(
        wa=73, ka=73, pb=16, kb=32, ec=12, kc=73)
    # past one CTA's shared memory: no plan
    with pytest.raises(ValueError):
        F.kernel_plan((20001, 20001, 20001), (10000,) * 3, (3,) * 3, 3, 8)


# ------------------------------------------------------------ the card
CARD_CASES = [(nelem, ngl) for nelem in ((3, 4), (2, 3, 2))
              for ngl in range(2, 7)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("nelem,ngl", CARD_CASES)
def test_card_kernels_match_plain(card, nelem, ngl, system, dtype):
    """Three launches a call; relative max-norm within 1e-5 (f32) / 1e-12
    (f64) of the plain version on the card; the same bits on a second
    call."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    ops, r = setup(nelem, ngl)
    f = moved(getattr(ops, system), card, dtype)
    rc = r.to(card, dtype)
    n0 = F.fdm_apply.launches
    z = F.fdm_apply(f, rc, ops.nelem, ops.ngl)
    torch.cuda.synchronize()
    assert F.fdm_apply.launches == n0 + 3
    ref = F.fdm_apply_ref(f, rc, ops.nelem, ops.ngl)
    assert float((z - ref).abs().max() / ref.abs().max()) <= tol
    assert torch.equal(F.fdm_apply(f, rc, ops.nelem, ops.ngl), z)


def random_fdm(npts, c, device, dtype, seed=0):
    """An FDMOps of random Qs, binv and a jleft that is zero at about two
    thirds of its entries (the kernels take any values)."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, dtype=F64)
    jl = rnd(int(np.prod(npts)), c)
    jl[jl.abs() < 1.0] = 0.0
    to = lambda t: t.to(device=device, dtype=dtype)
    return F.FDMOps(Qs=tuple(to(rnd(c, n, n)) for n in npts),
                    binv=to(rnd(c, c, *npts)), rep_rows=None,
                    cell_nodes=None, jleft=to(jl), npts=tuple(npts),
                    ncomp=c)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("nelem,ngl", [((1, 1099, 4), 2), ((1099, 1, 2), 2),
                                       ((24, 24, 24), 4), ((3, 1500), 2)])
def test_card_tiled_shapes(card, nelem, ngl, dtype):
    """Grids whose planes or pencils take several column blocks, k-chunks
    and rounds of tiles (np1 or np0 of 1,100), and the benchmark's 73^3:
    within the tolerances above of the plain version."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    c = len(nelem)
    npts = tuple(n * (ngl - 1) + 1 for n in nelem)
    f = random_fdm(npts, c, card, dtype)
    grid = torch.randn(npts + (c,), dtype=F64).to(card, dtype)
    r = F._grid_to_local(grid, nelem, ngl, c).contiguous()
    z = F.fdm_apply(f, r, nelem, ngl)
    ref = F.fdm_apply_ref(f, r, nelem, ngl)
    assert float((z - ref).abs().max() / ref.abs().max()) <= tol


@pytest.mark.card
@pytest.mark.parametrize("bound", [False, True])
def test_card_raises_on_a_bad_input(card, bound):
    """Before the first call binds the kernels' arguments and after."""
    ops, r = setup((2, 3, 2), 3)
    f = moved(ops.fdm_main, card, F64)
    rc = r.to(card)
    if bound:
        F.fdm_apply(f, rc, ops.nelem, ops.ngl)
    n0 = F.fdm_apply.launches
    with pytest.raises(ValueError):
        F.fdm_apply(f, rc[:, :-3], ops.nelem, ops.ngl)
    with pytest.raises(ValueError):
        F.fdm_apply(f, torch.cat([rc, rc], 1)[:, ::2], ops.nelem, ops.ngl)
    with pytest.raises(TypeError):
        F.fdm_apply(f, rc.float(), ops.nelem, ops.ngl)
    with pytest.raises(ValueError):
        F.fdm_apply(f, rc, (2, 2, 3), ops.ngl)
    assert F.fdm_apply.launches == n0
