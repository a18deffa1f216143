"""Port parity: pynama_tpu_torch.functions against pynama_tpu.functions.

Every registry entry (the `taylor_green_3d` alias included) and every field
it defines, at two times, on the same numpy-seeded coordinates in float64:
relative error <= 1e-13 (the fields are the same closed forms; only the
transcendental functions' last bits may differ). At t = 0 the flat plate's
tau is 0 and its fields must be inf/NaN exactly where the JAX ones are.
"""
import math

import numpy as np
import pytest
import torch

from pynama_tpu import functions as J
from pynama_tpu_torch import functions as T

torch.set_num_threads(1)

NU = 0.02
FIELDS = ("velocity", "vorticity", "convective", "diffusive")
TIMES = (0.0, 0.37)


def _coords(lib, seed=0, n=64):
    return np.random.default_rng(seed).uniform(-0.2, 1.2, (n, lib.DIM))


def _field(lib, name, coords, a):
    args = (NU,) if name == "diffusive" else ()
    with np.errstate(all="ignore"):
        return getattr(lib, name)(coords, a, *args)


def test_registry_matches():
    assert sorted(T.REGISTRY) == sorted(J.REGISTRY)
    assert T.get_function_lib("taylor_green_3d") is T.taylor_green_2d3d
    for name in T.REGISTRY:
        assert T.REGISTRY[name].DIM == J.REGISTRY[name].DIM
    with pytest.raises(KeyError, match="available"):
        T.get_function_lib("nope")


@pytest.mark.parametrize("name", sorted(J.REGISTRY))
@pytest.mark.parametrize("t", TIMES)
def test_alpha_matches(name, t):
    """alpha is host arithmetic: a Python float, equal to the JAX one."""
    a = T.get_function_lib(name).alpha(NU, t)
    assert type(a) is float
    assert math.isclose(a, float(J.get_function_lib(name).alpha(NU, t)),
                        rel_tol=1e-15, abs_tol=0.0)


@pytest.mark.parametrize("name", sorted(J.REGISTRY))
@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("t", TIMES)
def test_field_matches(name, field, t):
    lt, lj = T.get_function_lib(name), J.get_function_lib(name)
    c = _coords(lt)
    got = _field(lt, field, c, lt.alpha(NU, t))
    want = np.asarray(_field(lj, field, c, lj.alpha(NU, t)))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    got = got.numpy()
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    if fin.any():
        scale = max(float(np.abs(want[fin]).max()), 1e-300)
        assert float(np.abs(got[fin] - want[fin]).max()) <= 1e-13 * scale


def test_flat_plate_t0_is_not_finite():
    """tau = sqrt(4 nu 0) = 0: the JAX fields are non-finite there, and so
    are the port's (no ZeroDivisionError from host float arithmetic)."""
    lib = T.flat_plate
    assert lib.alpha(NU, 0.0) == 0.0
    c = _coords(lib)
    for field in ("vorticity", "convective", "diffusive"):
        assert not torch.isfinite(_field(lib, field, c, 0.0)).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tensor_in_keeps_dtype_and_device(dtype):
    """A tensor in gives a tensor of its dtype on its device; a numpy array
    gives a CPU tensor."""
    for name in sorted(T.REGISTRY):
        lib = T.get_function_lib(name)
        c = torch.as_tensor(_coords(lib, seed=1), dtype=dtype)
        a = lib.alpha(NU, 0.37)
        for field in FIELDS:
            out = _field(lib, field, c, a)
            assert out.dtype == dtype and out.device == c.device
            ref = _field(lib, field, c.double().numpy(), a)
            assert ref.device.type == "cpu"
            tol = 1e-5 if dtype == torch.float32 else 1e-15
            scale = max(float(ref.abs().max()), 1e-300)
            assert float((out.double() - ref).abs().max()) <= tol * scale
