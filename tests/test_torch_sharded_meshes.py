"""Port parity of the remaining sharded paths: K1's boundary planes `bnd`
exchanged between slabs (tests/test_fused.py::
test_sharded_fused_equivalence), gmsh meshes split into element ranges
(tests/test_unstructured.py::test_sharded_unstructured_transient and
::test_sharded_dss_interface_exchange) and the CLI's `-ndev`
(tests/test_cli.py::test_ndev_production_run).

The JAX side runs as those tests run it, on the virtual CPU devices; the
port on gloo ranks, at the JAX tests' tolerances. The interface-row test
is the suite's one 8-rank case.
"""
import numpy as np
import torch

import jax.numpy as jnp
from pynama_tpu.cases import Problem as JProblem
from pynama_tpu.engine import local_engine as JE
from pynama_tpu.parallel.sharded_engine import ShardedEngine as JShardedEngine
from pynama_tpu_torch.cases import Problem as TProblem
from pynama_tpu_torch.engine import local_engine as TE
from pynama_tpu_torch.parallel.sharded_engine import job_rhs, run_sharded

import torch_rank_jobs as jobs
from msh_fixtures import grid_quad_mesh, write_msh22
from test_fused import _tiny_problem
from test_torch_cli import assert_dirs_match, run_both
from test_torch_sharded_engine import F64, assert_lockstep
from test_unstructured import TG_BC, unstruct_config

torch.set_num_threads(1)


def test_sharded_fused_equivalence():
    """K1's raw-plane exchange (the port's fused_apply, its plain version
    here, on 4 ranks of the (4, 2, 2) ngl=3 cavity, one element layer
    each) against the JAX package's fused kernel under shard_map, and the
    port's single-device K1."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from pynama_tpu.parallel.sharded_engine import AXIS, build_sharded_ops

    pj = _tiny_problem(fused=True, nelem=(4, 2, 2), ngl=3)
    rng = np.random.default_rng(5)
    vg = rng.standard_normal((pj.mesh.n_nodes, pj.dim))
    ops_s = build_sharded_ops(pj.engine_ops, 4)
    fn = jax.shard_map(
        lambda o, t: JE.apply_K(jax.tree.map(lambda x: x[0], o), t[0])[None],
        mesh=Mesh(np.array(jax.devices()[:4]), (AXIS,)),
        in_specs=(jax.tree.map(lambda _: P(AXIS), ops_s), P(AXIS)),
        out_specs=P(AXIS), check_vma=False)
    v = jnp.asarray(pj.to_local(vg))
    want = pj.to_global(np.asarray(fn(ops_s, v.reshape((4, -1, v.shape[-1])))
                                   ).reshape(v.shape), pj.dim)

    pt = TProblem(pj.config, **F64, solver="cg", cg_rtol=1e-10,
                  cg_maxiter=400, fused=True)
    pt.setUp()
    ref = pt.to_global(TE.apply_K(pt.engine_ops, pt.to_local(vg)), pt.dim)
    res = run_sharded(pt, 4, jobs.apply_K, (vg,))
    got = res[0]["fields"]["y"]
    scale = float(np.abs(want).max() + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8 * scale)


def test_sharded_unstructured_transient(tmp_path):
    """A distorted gmsh mesh (4x4 quads, ngl=4, Taylor-Green BCs) split
    into element ranges: one rhs against the JAX package's ShardedEngine,
    and the whole -ndev transient against its -ndev run (same steps,
    1e-6 / 1e-9), 2 ranks each."""
    v, q, l = grid_quad_mesh(4, 4, distort=0.1)   # 16 cells -> 2 ranks
    path = str(tmp_path / "s.msh")
    write_msh22(path, v, q, l)
    cfg = {**unstruct_config(path, 4, TG_BC),
           "initial-conditions": {"custom-func": {"name": "taylor_green"}},
           "time-solver": {"start-time": 0, "end-time": 0.01,
                           "max-steps": 3}}
    opts = dict(solver="cg", cg_rtol=1e-12, cg_maxiter=4000)
    pj = JProblem(cfg, **opts)
    pj.setUp()
    pt = TProblem(cfg, **F64, **opts)
    pt.setUp()
    assert not pt.engine_ops.lay_v.structured
    rng = np.random.default_rng(4)
    vort = rng.standard_normal((pt.mesh.n_nodes, 1))
    vel = np.zeros((pt.mesh.n_nodes, 2))
    sk = JShardedEngine(pj, 2)
    vort_s, vel_s = sk.shard_state(vort, vel)
    f_s, _ = sk.make_rhs()(sk.ops_s, 0.1, vort_s, vel_s)
    res = run_sharded(pt, 2, job_rhs, (0.1, vort, vel))
    np.testing.assert_allclose(res[0]["fields"]["f"],
                               sk.gather_state(f_s, 1), rtol=1e-8,
                               atol=1e-10)
    assert_lockstep(res)

    pj2 = JProblem(cfg, ndev=2, **opts)
    pj2.setUp()
    tj, sj = pj2.start_solver(dt0=1e-3, atol=1e-4, rtol=1e-4)
    pt2 = TProblem(cfg, **F64, ndev=2, **opts)
    pt2.setUp()
    tt, st = pt2.start_solver(dt0=1e-3, atol=1e-4, rtol=1e-4)
    assert st == sj >= 2
    assert_lockstep([{"stats": s} for s in pt2.rank_stats])
    np.testing.assert_allclose(pt2.vort.numpy(), np.asarray(pj2.vort),
                               rtol=1e-6, atol=1e-9)


def test_sharded_dss_interface_exchange(tmp_path):
    """The cross-rank gather DSS sums only the partition-interface rows:
    an 8x8 quad grid in 8 element ranges, whose interface rows are the
    JAX package's, a surface subset shared by >= 2 ranks each; the
    restricted exchange equals the whole-vector psum bit for bit, and the
    JAX package's DSS to rounding."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from pynama_tpu.ops import local as JL
    from pynama_tpu.parallel.sharded_engine import AXIS

    v, q, l = grid_quad_mesh(8, 8, distort=0.1)   # 64 cells -> 8 ranks
    path = str(tmp_path / "i.msh")
    write_msh22(path, v, q, l)
    cfg = unstruct_config(path, 3, TG_BC)
    pj = JProblem(cfg, solver="cg", engine=True)
    pj.setUp()
    ndev = 8
    sk = JShardedEngine(pj, ndev)
    iface_j = np.asarray(sk.ops_s.lay_v.iface[0])
    n_nodes = pj.mesh.n_nodes
    rng = np.random.default_rng(0)
    tg = rng.standard_normal((n_nodes, 2))
    t = jnp.asarray(pj.to_local(tg))
    lay_s = sk.ops_s.lay_v
    f = jax.shard_map(
        lambda lay, ts: JL.dss(jax.tree.map(lambda x: x[0], lay), ts[0],
                               axis_name=AXIS)[None],
        mesh=Mesh(np.array(jax.devices()[:ndev]), (AXIS,)),
        in_specs=(jax.tree.map(lambda _: P(AXIS), lay_s), P(AXIS)),
        out_specs=P(AXIS), check_vma=False)
    want = np.asarray(f(lay_s, t.reshape(ndev, -1, t.shape[-1])))

    pt = TProblem(cfg, **F64, solver="cg", engine=True)
    pt.setUp()
    res = run_sharded(pt, ndev, jobs.dss_iface, (tg,))
    got = res[0]["fields"]
    np.testing.assert_array_equal(np.sort(got["iface"]), np.sort(iface_j))
    assert 0 < got["iface"].size < 0.5 * n_nodes
    cn = np.asarray(pt.mesh.cell_nodes)
    shard_of = np.repeat(np.arange(ndev), cn.shape[0] // ndev)
    shared = [np.unique(shard_of[(cn == nd).any(axis=1)]).size >= 2
              for nd in range(n_nodes)]
    np.testing.assert_array_equal(np.sort(got["iface"]),
                                  np.where(shared)[0])
    np.testing.assert_array_equal(got["got"], got["want"])
    np.testing.assert_allclose(got["got"], want.reshape(got["got"].shape),
                               rtol=1e-12, atol=1e-13)


def test_ndev_production_run(tmp_path, monkeypatch):
    """-ndev N runs the sharded transient end to end through run_case (the
    mpiexec -n analog) and writes the JAX package's files; 2 ranks and 2
    devices on cavity-2d at 8x4 ngl=3."""
    args = ["-case", "cavity-2d", "-log", "WARNING", "-nelem", "8", "4",
            "-ngl", "3", "-solver", "cg", "-ndev", "2", "-rtol", "1e-3",
            "-atol", "1e-3", "-dt0", "1e-3"]
    dj, dt, (p, t, steps) = run_both(tmp_path, monkeypatch, args)
    assert len(p.rank_stats) == 2 and steps > 0
    assert_lockstep([{"stats": s} for s in p.rank_stats])
    names = assert_dirs_match(dj / "cavity-2d-re100", dt / "cavity-2d-re100")
    assert sum(n.startswith("vec-data-") for n in names) == steps
