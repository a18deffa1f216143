"""Rank communication for slab-sharded runs: the port's own counterpart of
`jax.lax.psum` / `ppermute`, the rendezvous and the rank launcher.

The JAX package runs N shards in one process under `jax.shard_map` and lets
XLA's collectives join them. The port runs one `torch.distributed` rank per
shard. The engine code stays single-program: `EngineOps.comm` is a
`SlabComm`, which plays the role of the JAX package's `axis_name`, and
`comm=None` means one device, as `axis_name=None` does there.

`SlabComm` over the default process group:

  psum(x)      the sum over ranks. Computed as an all-gather and a sum in
               rank order, so every rank adds the same values in the same
               order and gets the same bits. The host loops that every rank
               runs on its own (the adaptive dt controller, the CG's
               stopping check) branch only on such sums, so they stay in
               lockstep: no rank takes a step or an iteration that another
               does not.
  exchange(l, r) -> (from_left, from_right)
               send `l` to rank-1 and `r` to rank+1 and receive theirs
               (batched isend/irecv), zeros at the two ends; the axis-0
               plane exchange of the slab DSS. `exchange_start` posts the
               same transfers and returns a handle whose `wait()` gives
               the pair (the overlapped DSS).
  all_gather(x) the per-rank tensors, in rank order.

The backend follows from the device and the cards, never from a failure
(`backend_for`): gloo on the CPU; NCCL on CUDA when there are no more
ranks than cards; on CUDA with more ranks than cards (two ranks on one
card, which NCCL does not take) gloo with every collective staged through
pinned host buffers: gloo's send of a CUDA tensor aborted the sending
rank on an H100 (its TCP transport wrote the device pointer), while its
all_reduce and all_gather took them; the psums and gathers are staged
too, so that one rule covers the mode. The staged mode is logged at INFO and shown as
`SlabComm.staged` (and `ShardedEngine.backend`); `staged_bytes` counts the
bytes it copied each way.

The launcher `run_ranks` starts N ranks with the spawn context of
`torch.multiprocessing`, each with a fresh `file://` rendezvous store under
a temporary directory (no TCP port to race for), one thread each
(`torch.set_num_threads(1)`), and a CUDA rank on card `rank % cards`. A
run has no deadline as a whole, however long it takes; what bounds a hang
is the collective timeout given to `init_process_group` (`timeout`,
COLLECTIVE_TIMEOUT by default): a rank that waits longer than that for a
peer in the rendezvous or in any one collective raises. When a rank
raises or exits without a result, `run_ranks` kills every rank and raises
with the traceback of the rank that failed first (the others' failures, a
collective whose peer went away, follow from it) and names the ranks that
gave no result, so a hung rank cannot hang the caller. Rank 0 can send
messages to the parent while it runs (`SlabComm.post`), which
`on_message` receives in order.
"""
from __future__ import annotations

import datetime
import logging
import os
import shutil
import tempfile
import time
import traceback
from multiprocessing.connection import wait as _wait_any

import torch
import torch.distributed as dist

logger = logging.getLogger("pynama_tpu_torch.parallel")

#: seconds a rank waits for its peers in the rendezvous or in any one
#: collective before it raises (and `run_ranks` kills every rank)
COLLECTIVE_TIMEOUT = 300.0
#: seconds `run_ranks` waits, after a first rank fails, for the others'
#: reports before it names the earliest failure
ERROR_SETTLE = 2.0


def backend_for(device, ndev: int) -> tuple:
    """(backend, staged) for `ndev` ranks on `device`'s kind: gloo on the
    CPU; on CUDA NCCL when ndev <= the cards, else gloo staged through
    host buffers."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", False
    if device.type != "cuda":
        raise ValueError(f"sharded runs take cpu or cuda, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested for a sharded run, but "
                           "torch.cuda.is_available() is False")
    if ndev <= torch.cuda.device_count():
        return "nccl", False
    return "gloo", True


class _Pending:
    """An exchange in flight: `wait()` -> (from_left, from_right). Holds the
    send buffers, which must outlive the transfers."""

    def __init__(self, comm, reqs, from_left, from_right, sent):
        self.comm, self.reqs, self.sent = comm, reqs, sent
        self.from_left, self.from_right = from_left, from_right

    def wait(self):
        for r in self.reqs:
            r.wait()
        return (self.comm._from_host(self.from_left),
                self.comm._from_host(self.from_right))


class SlabComm:
    """The collectives of one rank over the default process group (size 1
    and no group when torch.distributed is not initialized)."""

    def __init__(self, device):
        self.device = torch.device(device)
        if dist.is_available() and dist.is_initialized():
            self.rank, self.size = dist.get_rank(), dist.get_world_size()
            self.backend = str(dist.get_backend())
        else:
            self.rank, self.size, self.backend = 0, 1, None
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        if self.staged and self.rank == 0:
            logger.info("%d ranks on %s over gloo: every collective is "
                        "staged through pinned host buffers (NCCL takes "
                        "one rank per card)", self.size, self.device)
        #: bytes copied device -> host and host -> device by staging
        self.staged_bytes = 0
        #: rank 0's channel to whoever started the ranks (see post)
        self.on_message = None

    # ------------------------------------------------------------ staging
    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        x = x.detach().contiguous()
        if not self.staged:
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        self.staged_bytes += h.numel() * h.element_size()
        return h

    def _from_host(self, h: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return h
        self.staged_bytes += h.numel() * h.element_size()
        return h.to(self.device)

    def _empty_like_host(self, h: torch.Tensor) -> torch.Tensor:
        return torch.empty(h.shape, dtype=h.dtype, device=h.device,
                           pin_memory=self.staged)

    # -------------------------------------------------------- collectives
    def all_gather(self, x: torch.Tensor) -> list:
        """[x of rank 0, x of rank 1, ...], on x's device."""
        if self.size == 1:
            return [x]
        h = self._to_host(x)
        parts = [self._empty_like_host(h) for _ in range(self.size)]
        dist.all_gather(parts, h)
        return [self._from_host(p) for p in parts]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks, bitwise the same on every rank (an all-gather
        and a sum in rank order)."""
        if self.size == 1:
            return x
        h = self._to_host(x)
        parts = [self._empty_like_host(h) for _ in range(self.size)]
        dist.all_gather(parts, h)
        s = parts[0]
        for p in parts[1:]:
            s = s + p
        return self._from_host(s)

    def exchange_start(self, send_to_left: torch.Tensor,
                       send_to_right: torch.Tensor) -> _Pending:
        """Post the neighbour transfers (see `exchange`); `wait()` on the
        result gives (from_left, from_right)."""
        sl, sr = self._to_host(send_to_left), self._to_host(send_to_right)
        from_left = self._empty_like_host(sr).zero_()
        from_right = self._empty_like_host(sl).zero_()
        ops = []
        if self.rank > 0:
            ops += [dist.P2POp(dist.isend, sl, self.rank - 1),
                    dist.P2POp(dist.irecv, from_left, self.rank - 1)]
        if self.rank < self.size - 1:
            ops += [dist.P2POp(dist.isend, sr, self.rank + 1),
                    dist.P2POp(dist.irecv, from_right, self.rank + 1)]
        reqs = dist.batch_isend_irecv(ops) if ops else []
        return _Pending(self, reqs, from_left, from_right, (sl, sr))

    def exchange(self, send_to_left: torch.Tensor,
                 send_to_right: torch.Tensor) -> tuple:
        """(from_left, from_right): what rank-1 sent right and rank+1 sent
        left; zeros where there is no neighbour."""
        if self.size == 1:
            return torch.zeros_like(send_to_right), \
                torch.zeros_like(send_to_left)
        return self.exchange_start(send_to_left, send_to_right).wait()

    def barrier(self):
        if self.size > 1:
            dist.barrier()

    def post(self, msg) -> None:
        """Hand `msg` to `on_message` (rank 0 of spawned ranks: to the
        parent's `run_ranks(on_message=...)`; elsewhere dropped unless the
        caller set one)."""
        if self.on_message is not None:
            self.on_message(msg)


# ------------------------------------------------------------- launching
def _rank_main(rank, ndev, init_method, backend, device, timeout, inbox,
               conn):
    """Body of one spawned rank: read (target, args) from `inbox`, join the
    group, run target(comm, *args), send ("ok", rank, result) or ("error",
    rank, traceback)."""
    try:
        target, args = inbox.recv()
        inbox.close()
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, world_size=ndev, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        comm = SlabComm(dev)
        if rank == 0:
            comm.on_message = lambda m: conn.send(("msg", rank, m))
        out = target(comm, *args)
        comm.barrier()       # no rank leaves while a transfer is in flight
        conn.send(("ok", rank, out))
    except BaseException:
        conn.send(("error", rank, (time.time(), traceback.format_exc())))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


def run_ranks(target, rank_args, *, device, timeout=COLLECTIVE_TIMEOUT,
              on_message=None) -> list:
    """Run target(comm, *rank_args[r]) on len(rank_args) spawned ranks and
    return their results in rank order.

    `target` is a module-level function (the spawn context pickles it by
    name). A CUDA device without a card raises here, before any rank
    starts. `timeout` is each collective's limit (see the module
    docstring), not the run's. A rank that raises, or dies, makes this
    raise RuntimeError with the traceback of the rank that failed first,
    after every rank is killed."""
    ndev = len(rank_args)
    device = torch.device(device)
    backend, staged = backend_for(device, ndev)
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="pynama-ranks-")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    procs, conns = [], []
    try:
        # the payloads go through pipes of their own once every rank has
        # started: in the spawn arguments a large one would hold up each
        # start until that rank had imported its modules
        inboxes = []
        for r in range(ndev):
            in_recv, in_send = ctx.Pipe(duplex=False)
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                r, ndev, init_method, backend, str(device), timeout,
                in_recv, send))
            p.start()
            in_recv.close()
            send.close()
            procs.append(p)
            conns.append(recv)
            inboxes.append(in_send)
        for r, box in enumerate(inboxes):
            try:
                box.send((target, rank_args[r]))
            except (BrokenPipeError, ConnectionResetError):
                procs[r].join(10)
                raise RuntimeError(
                    f"rank {r} of {ndev} exited with code "
                    f"{procs[r].exitcode} before it took its job; a script "
                    "that starts ranks needs the `if __name__ == "
                    "'__main__':` guard (the spawn context imports the main "
                    "module in every rank)") from None
            box.close()
        results, done = [None] * ndev, set()
        failures = {}        # rank -> (time of failure, what happened)
        settle = None        # after a first failure, a moment for others
        while len(done) < ndev:
            if settle is not None and time.monotonic() >= settle:
                break
            live = [r for r in range(ndev) if r not in done]
            ready = _wait_any([conns[r] for r in live]
                              + [procs[r].sentinel for r in live],
                              None if settle is None
                              else max(settle - time.monotonic(), 0.0))
            for r in live:
                c, kind = conns[r], None
                if c in ready or c.poll():
                    try:
                        kind, _, payload = c.recv()
                    except EOFError:
                        kind = "died"
                    if kind == "msg":
                        if on_message is not None:
                            on_message(payload)
                        continue
                    if kind == "ok":
                        results[r] = payload
                        done.add(r)
                        continue
                if kind == "error":
                    failures[r] = (payload[0], f"raised:\n{payload[1]}")
                elif kind == "died" or (procs[r].sentinel in ready
                                        and not c.poll()):
                    procs[r].join(5)
                    failures[r] = (time.time(), "exited with code "
                                   f"{procs[r].exitcode} without a result")
                else:
                    continue
                done.add(r)
                if settle is None:
                    settle = time.monotonic() + ERROR_SETTLE
        if failures:
            # the first failure is the cause; the others' (a collective
            # whose peer went away) follow from it
            r = min(failures, key=lambda k: failures[k][0])
            silent = [k for k in range(ndev) if k not in done]
            raise RuntimeError(
                f"rank {r} of {ndev} {failures[r][1]}\n(ranks {silent} of "
                f"{ndev} gave no result; all ranks killed)")
        for p in procs:
            p.join(30)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        for c in conns:
            c.close()
        shutil.rmtree(tmp, ignore_errors=True)
