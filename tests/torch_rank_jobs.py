"""Rank jobs for the port's sharding tests (tests/test_torch_sharded_*.py).

Spawned ranks import the jobs they run by module name, so the jobs live in
a module that imports only the port (no jax, no pynama_tpu): each rank then
pays for torch and the port alone. Every job takes the rank's
ShardedEngine (`parallel/sharded_engine.py::run_sharded`) or its SlabComm
(`parallel/comm.py::run_ranks`).
"""
import dataclasses

import numpy as np
import torch

from pynama_tpu_torch.engine import local_engine as E
from pynama_tpu_torch.ibm.sharded import correction_local
from pynama_tpu_torch.ops import local as L


def apply_K(se, v_g):
    """apply_K on the rank's slab of the global velocity v_g, gathered."""
    v_s, _ = se.shard_state(v_g, v_g)
    return se.result(y=se.gather_state(E.apply_K(se.ops_s, v_s),
                                       se.ops_s.dim))


def attempt(se, t, dt, vort_g, vel_g, atol=1e-4, rtol=1e-4,
            tableau="5bs"):
    """One sharded trial step: fields y (the 5th-order vorticity), vel
    and enorm (the global error norm, a float)."""
    res = se.attempt(t, dt, *se.shard_state(vort_g, vel_g), tableau=tableau,
                     atol=atol, rtol=rtol)
    return se.result(y=se.gather_state(res.y, se.ops_s.dim_w),
                     vel=se.gather_state(res.aux, se.ops_s.dim),
                     enorm=float(res.enorm))


def dss_iface(se, t_g):
    """The gather DSS of the rank's slab with the interface-row psum and
    with the whole-vector psum (iface=None): both slabs, gathered whole in
    the local layout, and the interface rows."""
    lay = se.ops_s.lay_v
    t_s, _ = se.shard_state(t_g, t_g)
    full = dataclasses.replace(lay, iface=None)
    got = torch.cat(se.comm.all_gather(L.dss(lay, t_s, se.comm)))
    want = torch.cat(se.comm.all_gather(L.dss(full, t_s, se.comm)))
    return se.result(got=got.numpy(), want=want.numpy(),
                     iface=lay.iface.numpy())


def correction_ranks(comm, slots, gw, sw, chol, scale, vel_l, body_vel):
    """correction_local on this rank's tables and slab: (corrected slab,
    flux)."""
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    out, flux = correction_local(
        torch.as_tensor(slots), f(gw), f(sw), f(chol), scale, f(vel_l),
        f(body_vel), comm)
    return out.numpy(), flux.numpy()


def fail_on_rank_1(comm):
    """Rank 1 raises; the others wait in a collective that never ends."""
    if comm.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    comm.psum(torch.ones(1))


def hang_on_rank_1(comm):
    """Rank 1 never returns; the others finish."""
    if comm.rank == 1:
        import time
        time.sleep(3600)
    return comm.rank
