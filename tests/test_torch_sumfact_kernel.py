"""The sumfact K's kernel route (ops/sumfact.py apply_sumfact_k,
csrc/sumfact_apply.cu) and what the CPU can check of it.

The kernel applies the 1D tables of `one_d_tables` axis by axis; the
eager chain (`apply_sumfact_k_ref`) applies their Kronecker products, the
flat tables Df_flat and Dr_flat. On the CPU: those products reproduce the
flat tables for every (dim, ngl) the kernel takes, `sumfact_arrays` gives
bitwise what it gave before the tables were split out into
`one_d_tables`, `apply_sumfact_k` on a CPU tensor is bitwise the plain
version and launches nothing, and the input check raises on what the
kernel does not take.

Tests marked `card` compare the kernel with the plain version on an
NVIDIA card at every instantiated (dim, ngl), and skip without one. The
file imports no JAX; on the card run them without the JAX-loading
conftest: `python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_sumfact_kernel.py`.
"""
import numpy as np
import pytest
import torch

from pynama_tpu_torch.basis import make_tensor_basis
from pynama_tpu_torch.basis.lagrange import lagrange_basis
from pynama_tpu_torch.basis.quadrature import gauss_points, lobatto_points
from pynama_tpu_torch.ops import sumfact as S

torch.set_num_threads(1)

F64 = torch.float64
SHAPES = [(dim, ngl) for dim in S.KERNEL_DIMS for ngl in S.KERNEL_NGL]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def corners(rng, dim, n):
    """(n, 2**dim, dim) corners of unit elements, each corner moved by
    uniform(-0.15, 0.15) per axis."""
    unit = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float) if dim == 2 \
        else np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                       [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    return unit[None] + rng.uniform(-0.15, 0.15, (n,) + unit.shape)


def setup(dim, ngl, n, device="cpu", dtype=F64, seed=0):
    rng = np.random.default_rng(seed + 10 * ngl + dim)
    sf = S.build_sumfact(make_tensor_basis(ngl, dim), corners(rng, dim, n),
                         device=device, dtype=dtype)
    t = torch.as_tensor(rng.standard_normal((n, dim * ngl ** dim)),
                        dtype=dtype, device=device)
    return sf, t


def unpack(ngl):
    """Hf, Df, Hr, Dr as the kernel's arguments carry them."""
    tab = S.kernel_tables(ngl)
    sizes = [(ngl, ngl), (ngl, ngl), (ngl - 1, ngl), (ngl - 1, ngl)]
    out, k = [], 0
    for shape in sizes:
        out.append(tab[k:k + shape[0] * shape[1]].reshape(shape))
        k += shape[0] * shape[1]
    assert k == tab.size <= S.TAB_SLOTS
    return out


def kron_flat(H, D, dim):
    """(nn, dim·nq): column block r is the Kronecker product over the axes
    (axis 0 slowest) of D on axis r and H elsewhere, transposed."""
    cols = []
    for r in range(dim):
        M = np.ones((1, 1))
        for ax in range(dim):
            M = np.kron(M, D if ax == r else H)
        cols.append(M.T)
    return np.concatenate(cols, axis=1)


@pytest.mark.parametrize("dim,ngl", SHAPES)
def test_kernel_tables_reproduce_flat_tables(dim, ngl):
    sf, _ = setup(dim, ngl, 2)
    Hf, Df, Hr, Dr = unpack(ngl)
    for H, D, flat in ((Hf, Df, sf.Df_flat), (Hr, Dr, sf.Dr_flat)):
        want = flat.numpy()
        got = kron_flat(H, D, dim)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-15 * np.abs(want).max()


@pytest.mark.parametrize("dim,ngl", SHAPES)
def test_sumfact_arrays_tables_unchanged(dim, ngl):
    """The flat tables as sumfact_arrays built them before one_d_tables:
    the same lagrange_basis calls, inline."""
    nodes1d, _ = lobatto_points(ngl)
    fq = gauss_points(ngl)[0] if ngl <= 3 else lobatto_points(ngl)[0]
    rq, _ = gauss_points(ngl - 1)
    Hf, Df = lagrange_basis(nodes1d, fq)
    Hr, Dr = lagrange_basis(nodes1d, rq)
    for got, want in zip(S.one_d_tables(ngl), (Hf, Df, Hr, Dr)):
        np.testing.assert_array_equal(got, want)
    arrays = S.sumfact_arrays(make_tensor_basis(ngl, dim),
                              corners(np.random.default_rng(1), dim, 3))
    np.testing.assert_array_equal(arrays["Df_flat"],
                                  S._flat_stack(Hf, Df, dim))
    np.testing.assert_array_equal(arrays["Dr_flat"],
                                  S._flat_stack(Hr, Dr, dim))


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("dim,ngl", [(2, 3), (2, 5), (3, 3), (3, 4)])
def test_cpu_route_is_the_plain_version(dim, ngl, dtype):
    sf, t = setup(dim, ngl, 5, dtype=dtype)
    n0 = S.apply_sumfact_k.launches
    assert torch.equal(S.apply_sumfact_k(sf, t), S.apply_sumfact_k_ref(sf, t))
    assert S.apply_sumfact_k.launches == n0 == 0
    assert id(sf) not in S._BLOCKS


@pytest.mark.parametrize("bad", ["strided", "width", "rows", "dtype",
                                 "not_a_tensor"])
def test_input_check_raises(bad):
    sf, t = setup(3, 3, 4)
    arg = {"strided": torch.cat([t, t], 1)[:, ::2],
           "width": t[:, :-3].contiguous(),
           "rows": t[:-1].contiguous(),
           "dtype": t.float(),
           "not_a_tensor": t.numpy()}[bad]
    assert bad == "not_a_tensor" or arg.is_contiguous() == (bad != "strided")
    with pytest.raises((TypeError, ValueError)):
        S.check_input(sf, arg)
    with pytest.raises((TypeError, ValueError)):
        S.apply_sumfact_k(sf, arg)
    assert S.apply_sumfact_k.launches == 0


def test_args_mirror_the_kernel_struct():
    """_Args as csrc/sumfact_apply.cu's Args lays it out: six pointers,
    E, four ints, two doubles, the table slots."""
    a = S._Args
    assert a.E.offset == 48 and a.dim.offset == 56 and a.pad.offset == 68
    assert a.alpha_w.offset == 72 and a.tab.offset == 88
    assert a.tab.size == 8 * S.TAB_SLOTS == 8 * 4 * 8 * 8


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("dim,ngl", SHAPES)
def test_card_kernel_matches_plain(card, dim, ngl, dtype):
    """One launch per call at 37 elements (a ragged last CTA at every
    shape) and on a t that starts one value off 16-byte alignment: relative
    max-norm within 1e-5 (f32) / 1e-12 (f64) of the plain version on the
    card."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    sf, t = setup(dim, ngl, 37, device=card, dtype=dtype)
    n0 = S.apply_sumfact_k.launches
    y = S.apply_sumfact_k(sf, t)
    torch.cuda.synchronize()
    ref = S.apply_sumfact_k_ref(sf, t)
    assert S.apply_sumfact_k.launches == n0 + 1
    assert float((y - ref).abs().max() / ref.abs().max()) <= tol
    buf = torch.empty(t.numel() + 1, dtype=dtype, device=card)
    t_off = buf[1:].view(t.shape)
    t_off.copy_(t)
    y_off = S.apply_sumfact_k(sf, t_off)
    torch.cuda.synchronize()
    assert float((y_off - ref).abs().max() / ref.abs().max()) <= tol


@pytest.mark.card
def test_card_raises_on_a_bad_input(card):
    sf, t = setup(3, 3, 4, device=card)
    n0 = S.apply_sumfact_k.launches
    with pytest.raises(ValueError):
        S.apply_sumfact_k(sf, t[:, :-3])
    with pytest.raises(ValueError):
        S.apply_sumfact_k(sf, t.cpu())
    assert S.apply_sumfact_k.launches == n0
