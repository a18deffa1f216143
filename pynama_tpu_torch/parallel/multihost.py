"""Multi-process entry points (the mpiexec / PETSc COMM_WORLD analog).

Port of pynama_tpu/parallel/multihost.py. The reference launches one MPI
rank per process (`makefile:2-7`); the JAX package uses `jax.distributed`
and a global device mesh. The port uses `torch.distributed`: after
`initialize()` every process is one rank of the default process group, and
a `Problem(..., ndev=N)` run on every rank shards in place over that group
(`parallel/sharded_engine.py`, route (ii)).

Usage (the same script on every process, e.g. under
`python -m torch.distributed.run --nproc-per-node N script.py`):

    from pynama_tpu_torch.parallel.multihost import initialize
    info = initialize(device="cpu")            # env-driven under torchrun
    p = Problem(cfg, device=info["device"], solver="cg",
                ndev=info["process_count"])
    p.setUp(); p.start_solver()                # every rank, in lockstep

Without a launcher's environment, pass coordinator_address ("host:port"),
num_processes and process_id. The backend follows
`parallel/comm.py::backend_for`: gloo on the CPU, NCCL with one card per
process, gloo staged through host buffers when processes share a card.
"""
from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from pynama_tpu_torch.parallel.comm import COLLECTIVE_TIMEOUT, backend_for

logger = logging.getLogger("pynama_tpu_torch.multihost")


def _local_device(device) -> torch.device:
    """This process's device: cuda:LOCAL_RANK (mod the cards) for cuda,
    else the device as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device) -> dict:
    """Join the default process group (nothing to do when one is up) and
    report the topology: process_index, process_count, local_devices,
    global_devices (the JAX package's keys) and this process's `device`.

    With no arguments the launcher's environment is read (torchrun's
    MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE); otherwise the coordinator is
    tcp://coordinator_address."""
    if not dist.is_initialized():
        if coordinator_address is not None:
            world, rank = int(num_processes), int(process_id)
            init = f"tcp://{coordinator_address}"
        else:
            world = int(os.environ["WORLD_SIZE"])
            rank = int(os.environ["RANK"])
            init = "env://"
        # processes on this machine against its cards
        backend, _ = backend_for(device, int(os.environ.get(
            "LOCAL_WORLD_SIZE", world)))
        dist.init_process_group(
            backend, init_method=init, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    dev = _local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    info = {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_devices": 1,
            "global_devices": dist.get_world_size(),
            "device": dev}
    logger.info("multihost topology: %s", info)
    return info


def is_primary() -> bool:
    """True on rank 0 (logging/IO gating); True without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0
