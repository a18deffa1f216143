"""Port parity: pynama_tpu_torch.ops.sumfact against pynama_tpu.ops.sumfact
and against the dense per-element K, and the engine's `sumfact=` option.

`apply_sumfact_k` is held to the JAX package's and to the dense K of
`compute_kle_matrices` at 1e-12 relative (float64) on random distorted
elements (tests/test_sumfact.py's four (dim, ngl) cases and its mirrored
element). In the engine, K is sum-factorized by default on gmsh meshes;
on a box mesh `sumfact=True` reaches the engine (it was once taken and
ignored), where apply_K is the sumfact product followed by K1's DSS pass
(`dss_pass`; its plain version here), matching the JAX package's route.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynama_tpu.basis import make_tensor_basis as jbasis
from pynama_tpu.cases import Problem as JProblem
from pynama_tpu.engine import local_engine as JE
from pynama_tpu.ops.sumfact import apply_sumfact_k as japply
from pynama_tpu.ops.sumfact import build_sumfact as jbuild
from pynama_tpu_torch.basis import make_tensor_basis
from pynama_tpu_torch.cases import Problem as TProblem
from pynama_tpu_torch.elements import compute_kle_matrices
from pynama_tpu_torch.engine import local_engine as TE
from pynama_tpu_torch.ops import sumfact as S
from test_sumfact import _distorted_corners
from test_torch_unstructured import (F64, TG, fields, gmsh_config, rel,
                                     transients_match, write_mesh)

torch.set_num_threads(1)

ZERO = [0, 0, 0]


def _dense(corners, dim, ngl, t):
    em = compute_kle_matrices(make_tensor_basis(ngl, dim), corners)
    return np.einsum("ei,eoi->eo", t, em.K)


@pytest.mark.parametrize("dim,ngl", [(2, 3), (2, 5), (3, 3), (3, 4)])
def test_sumfact_matches_jax_and_dense(dim, ngl):
    rng = np.random.default_rng(11)
    n_elem = 5
    corners = _distorted_corners(rng, dim, n_elem)
    sf = S.build_sumfact(make_tensor_basis(ngl, dim), corners, device="cpu",
                         dtype=F64)
    jsf = jbuild(jbasis(ngl, dim), corners, jnp.float64)
    for k in S.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(sf, k)),
                                      np.asarray(getattr(jsf, k)), err_msg=k)
    assert (sf.nqf, sf.nqr) == (jsf.nqf, jsf.nqr)
    t = rng.standard_normal((n_elem, ngl ** dim * dim))
    got = S.apply_sumfact_k(sf, torch.as_tensor(t)).numpy()
    assert rel(got, japply(jsf, jnp.asarray(t))) <= 1e-12
    assert rel(got, _dense(corners, dim, ngl, t)) <= 1e-12


def test_sumfact_negative_orientation_abs_det():
    """A mirrored element contributes with w|J|, not w·det(J): its
    weights stay positive, so its product is the dense K's (whose w·det J
    keeps the sign) with the sign of det J; meshes are oriented positively
    before either is built."""
    rng = np.random.default_rng(3)
    dim, ngl = 2, 4
    corners = _distorted_corners(rng, dim, 1)
    flipped = corners[:, :, ::-1].copy()      # swap x/y: det < 0
    basis = make_tensor_basis(ngl, dim)
    t = rng.standard_normal((1, ngl ** dim * dim))
    for c, sign in ((corners, 1.0), (flipped, -1.0)):
        sf = S.build_sumfact(basis, c, device="cpu", dtype=F64)
        assert float(sf.wr.min()) > 0
        got = S.apply_sumfact_k(sf, torch.as_tensor(t)).numpy()
        assert rel(got, sign * _dense(c, dim, ngl, t)) <= 1e-12
        jsf = jbuild(jbasis(ngl, dim), c, jnp.float64)
        assert rel(got, japply(jsf, jnp.asarray(t))) <= 1e-12


def test_engine_sumfact_default_on_unstructured(tmp_path):
    """Gmsh meshes get the sum-factorized K by default and the dense KT
    never reaches the device; apply_K and the KLE solve agree with the
    dense route (tests/test_sumfact.py's check, port against port)."""
    path = write_mesh(tmp_path / "sf.msh", "quad", (4, 3), 0.12)
    cfg = gmsh_config(path, 4, {"free-slip": {
        "up": [1, 0], "down": [1, 0], "left": [1, 0], "right": [1, 0]}})
    opts = dict(device="cpu", dtype=F64, solver="cg", cg_rtol=1e-11,
                cg_maxiter=600)
    p_sf = TProblem(cfg, **opts)
    p_sf.setUp()
    p_dn = TProblem(cfg, sumfact=False, **opts)
    p_dn.setUp()
    assert p_sf.engine_ops.sumfact is not None
    assert p_sf.engine_ops.KT.numel() == 0
    assert p_dn.engine_ops.sumfact is None
    assert p_dn.engine_ops.KT.shape == (12, 32, 32)

    rng = np.random.default_rng(5)
    v = p_sf.to_local(rng.standard_normal((p_sf.mesh.n_nodes, 2)))
    a = TE.apply_K(p_sf.engine_ops, v)
    b = TE.apply_K(p_dn.engine_ops, v)
    assert rel(a.numpy(), b.numpy()) < 1e-11
    w = TE.curl(p_dn.engine_ops, v)
    _, vel_sf = TE.solve_kle_local(p_sf.engine_ops, w, torch.zeros_like(v),
                                   0.0)
    _, vel_dn = TE.solve_kle_local(p_dn.engine_ops, w, torch.zeros_like(v),
                                   0.0)
    err = float((vel_sf - vel_dn).abs().max())
    assert err < 1e-7 * (1 + float(vel_dn.abs().max())), err


def _box_cfg():
    return {"name": "box-sf", "material-properties": {"rho": 0.5,
                                                      "mu": 0.01},
            "domain": {"ngl": 3, "box-mesh": {
                "nelem": [3, 2, 2], "lower": ZERO, "upper": [1, 1, 1]}},
            "time-solver": {"start-time": 0, "end-time": 1.0,
                            "max-steps": 2},
            "boundary-conditions": {"no-slip": {
                "up": [1, 0, 0], "down": ZERO, "left": ZERO, "right": ZERO,
                "back": ZERO, "front": ZERO}},
            "initial-conditions": {"vorticity": ZERO}}


def test_box_sumfact_reaches_engine(monkeypatch):
    """sumfact=True on a box mesh reaches the engine (the JAX package's
    rule: None means on for gmsh meshes only): apply_K goes through the
    sumfact product and K1's DSS pass, equals the JAX package's sumfact
    route and the dense K1 route; fused=False takes the plain DSS and
    gives the same bits; rhs_local matches the JAX package's."""
    opts = dict(solver="cg", cg_rtol=1e-13, cg_maxiter=4000)
    pt = TProblem(_box_cfg(), device="cpu", dtype=F64, sumfact=True, **opts)
    pt.setUp()
    ops = pt.engine_ops
    assert ops.sumfact is not None and ops.KT.numel() == 0
    assert ops.lay_v.structured and ops.fused
    pd = TProblem(_box_cfg(), device="cpu", dtype=F64, **opts)
    pd.setUp()
    assert pd.engine_ops.sumfact is None
    pj = JProblem(_box_cfg(), sumfact=True, **opts)
    pj.setUp()
    assert pj.engine_ops.sumfact is not None

    passes = []
    real = TE.dss_pass
    monkeypatch.setattr(TE, "dss_pass", lambda *a, **k: passes.append(1)
                        or real(*a, **k))
    vel, vort = fields(pj, 7)
    v = torch.as_tensor(vel)
    y = TE.apply_K(ops, v)
    assert len(passes) == 1
    assert rel(y.numpy(), JE.apply_K(pj.engine_ops, jnp.asarray(vel))) \
        <= 1e-12
    assert rel(y.numpy(), TE.apply_K(pd.engine_ops, v).numpy()) <= 1e-11
    plain = dataclasses.replace(ops, fused=False)
    assert torch.equal(TE.apply_K(plain, v), y) and len(passes) == 1

    fj, uj = JE.rhs_local(pj.engine_ops, 0.0, jnp.asarray(vort),
                          jnp.asarray(vel))
    ft, ut = TE.rhs_local(ops, 0.0, torch.as_tensor(vort), v)
    assert rel(ut.numpy(), uj) <= 1e-10 and rel(ft.numpy(), fj) <= 1e-10


@pytest.mark.parametrize("sumfact", [True, False])
def test_box_sumfact_transient_matches(sumfact):
    """Two steps of the no-slip box cavity with and without sumfact=True,
    against the JAX package's transient under the same option."""
    pt = transients_match(_box_cfg(), dt0=1e-3, tol=1e-4, solver="cg",
                          cg_rtol=1e-12, cg_maxiter=4000, sumfact=sumfact)
    assert (pt.engine_ops.sumfact is not None) == sumfact


def test_sumfact_default_rule(tmp_path):
    """sumfact=None: off on a box mesh, on on a gmsh mesh; sumfact=False
    keeps the dense K on a gmsh mesh."""
    path = write_mesh(tmp_path / "r.msh", "quad", (2, 2), 0.1)
    cfg = gmsh_config(path, 3, TG, TG, TG)
    box = dict(cfg, domain={"ngl": 3, "box-mesh": {
        "nelem": [2, 2], "lower": [0, 0], "upper": [1, 1]}})
    got = {}
    for name, c in (("gmsh", cfg), ("box", box)):
        for sf in (None, True, False):
            p = TProblem(c, device="cpu", dtype=F64, solver="cg",
                         sumfact=sf)
            p.setUp()
            got[name, sf] = p.engine_ops.sumfact is not None
    assert got == {("gmsh", None): True, ("gmsh", True): True,
                   ("gmsh", False): False, ("box", None): False,
                   ("box", True): True, ("box", False): False}
