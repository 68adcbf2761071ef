"""Data parallelism over torch.distributed (own copy of the data-axis part
of deepvision_tpu/parallel/mesh.py: `maybe_init_distributed`,
`check_batch_divisible`, `pad_to_multiple`, and the per-process rows of
`shard_batch_pytree`).

The JAX trainer builds a mesh over every device and shards each batch over
its `data` axis; GSPMD inserts the collectives. Here one process drives one
device (a rank), `torch.distributed` carries the collectives, and the
config's `batch_size` stays the global batch: each rank takes
`batch_size // world_size()` rows. Without a process group every helper
is the one-process identity, so a run that nobody launched with several
processes does what it did before.

A launch is `torchrun --standalone --nproc_per_node=N <entry point> ...`:
`maybe_init_distributed` reads torchrun's RANK, WORLD_SIZE and LOCAL_RANK.
NCCL carries the collectives on CUDA, gloo on the CPU. Only `all_reduce`,
`broadcast` (DDP's, at wrap time) and `barrier` are used, which gloo also
runs on CUDA tensors: two ranks can share one card over gloo, where NCCL
refuses. Decisions every rank must take alike (stop, halt, save, which
checkpoint to restore) are reached on the host over a gloo group, without
a device sync.
The model, spatial and shard_map axes of the JAX mesh are not ported yet.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

_control = None        # the gloo group of the host-side decisions


def is_initialized() -> bool:
    """True when a default process group is up."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0 (or no group): the one process that writes and prints."""
    return rank() == 0


def local_rank() -> int:
    """This process's rank on its host (torchrun's LOCAL_RANK), 0 when the
    launcher does not say: the index of the card it drives."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def maybe_init_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None) -> bool:
    """Bring up the default process group when the environment says this
    process is one rank of several (torchrun's RANK and WORLD_SIZE), and on
    a host with cards make card LOCAL_RANK the current device. `backend`
    defaults to NCCL where CUDA is available, gloo elsewhere;
    `init_method` defaults to torchrun's `env://`. Idempotent: a group
    that is already up is adopted as it is. Returns whether a group is up
    (False, and nothing done, for a plain one-process run)."""
    if is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    if cuda and local_rank() < torch.cuda.device_count():
        torch.cuda.set_device(local_rank())
    elif backend == "nccl":
        raise RuntimeError(
            f"LOCAL_RANK={local_rank()} has no card: this host has "
            f"{torch.cuda.device_count() if cuda else 0}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def spawn_ranks(fn: Callable, args: tuple = (), world: int = 2,
                backend: str = "gloo", same_card: bool = False,
                threads: int = 1, timeout: float = 600.0) -> None:
    """`fn(*args)` in `world` fresh processes, each one rank of a group over
    `backend` that meets at a FileStore in a temporary directory (no port),
    rank r on card r, or every rank on card 0 with `same_card` (gloo: NCCL
    refuses two ranks on one card), each with `threads` intra-op threads.
    A rank's exception is raised here; after `timeout` seconds the ranks
    are killed and TimeoutError raised."""
    with tempfile.TemporaryDirectory(prefix="ranks_") as d:
        ctx = torch.multiprocessing.spawn(
            _rank_main, args=(world, backend, f"file://{d}/store", same_card,
                              threads, fn, args), nprocs=world, join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout:g} s")


def _rank_main(rank: int, world: int, backend: str, init_method: str,
               same_card: bool, threads: int, fn: Callable,
               args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0" if same_card else str(rank))
    torch.set_num_threads(threads)
    maybe_init_distributed(backend, init_method=init_method)
    try:
        fn(*args)
    finally:
        destroy()


def destroy() -> None:
    """Tear the process group (and the host-side one) down, if one is up."""
    global _control
    if is_initialized():
        dist.destroy_process_group()
    _control = None


def _control_group():
    """The group of host-side decisions: the default group when it is
    gloo, else a gloo group over the same ranks (made once, by every rank
    at the same call)."""
    global _control
    if _control is None:
        _control = (dist.group.WORLD if dist.get_backend() == "gloo"
                    else dist.new_group(backend="gloo"))
    return _control


def agree_any(flag: bool) -> bool:
    """True on every rank when `flag` is true on any: the stop and halt
    decisions, taken on the host."""
    if not is_initialized():
        return flag
    t = torch.tensor([float(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_control_group())
    return bool(t.item())


def barrier() -> None:
    """Every rank waits here for the others (a host-side barrier)."""
    if is_initialized():
        dist.barrier(group=_control_group())


def broadcast_object(obj=None, src: int = 0):
    """Rank `src`'s picklable `obj` on every rank (a host-side decision
    one rank takes for all; `obj` itself without a group)."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_control_group())
    return box[0]


def pad_to_multiple(n: int, k: int) -> int:
    return int(math.ceil(n / k) * k)


def check_batch_divisible(batch_size: int, world: int,
                          what: str = "batch_size") -> None:
    """Batches split over the ranks with no padding: fail early with a
    remedy, in the JAX package's words."""
    if batch_size % world != 0:
        down = (batch_size // world) * world
        nearest = max(world, down if batch_size - down <= world // 2
                      else down + world)
        raise ValueError(
            f"global {what}={batch_size} must be divisible by the mesh "
            f"data axis ({world} devices); nearest valid: {nearest}")


def shard_rows(array, rank_: int, world: int):
    """Rows [rank·b, (rank + 1)·b) of a global batch of world·b rows: this
    rank's part, as the JAX mesh's data axis places it."""
    check_batch_divisible(len(array), world)
    b = len(array) // world
    return array[rank_ * b:(rank_ + 1) * b]


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks in place (nothing without a group)."""
    if is_initialized():
        dist.all_reduce(t)
    return t


def global_means(metrics: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Per-rank means of equal row counts → the global batch's means, in
    one collective on the device (the same dict without a group)."""
    if not is_initialized():
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().double() for k in keys])
    dist.all_reduce(stacked)
    stacked /= world_size()
    return {k: v.to(metrics[k].dtype) for k, v in zip(keys, stacked)}
