"""The epoch cache of the whole-epoch path (own copy of
deepvision_tpu/data/device_cache.py: `EpochCacheOverflowWarning`,
`hbm_budget_bytes`, `DeviceEpochCache`, `build_epoch_cache`).

Under `TrainConfig.epoch_on_device` the trainer stages the first trained
epoch's batches on the device once, stacked along a leading steps axis,
and every epoch is then one pass of the train step over those slices
(`core/steps.py::make_epoch_train_step`): no host batch and no host sync
until the epoch ends.

Contract: the data must be **epoch-stationary**. The cache replays the
first trained epoch's stream; the variety of later epochs comes from the
device-side shuffle (a permutation drawn per (seed, epoch)) and the
per-(seed, step) augment draws, not from the host pipeline running again.

Overflow is the reference's documented fallback, not a hidden one:
`build_epoch_cache` sizes the epoch against the budget while collecting
and, on overflow (or a ragged or empty stream, which cannot be stacked),
emits the named `EpochCacheOverflowWarning` and hands back an iterator
that replays the batches already pulled and then the rest of the stream.
The caller trains that epoch, and the rest of the run, through the staged
loop (`parallel/prefetch.py`), on the same device, with nothing lost.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils.device import to_device

# share of the card's free memory the cache may claim; the rest belongs to
# the parameters, the optimizer's state and the activations.
# DEEPVISION_EPOCH_CACHE_MAX_BYTES (an absolute byte cap) overrides it.
HBM_BUDGET_FRACTION = 0.5


class EpochCacheOverflowWarning(UserWarning):
    """The epoch does not fit the device cache (the budget is exceeded, or
    the batch stream is ragged or empty and cannot be stacked); training
    falls back to the staged per-batch loop."""


def hbm_budget_bytes(device: torch.device) -> Optional[int]:
    """The cache's byte budget, or None for no limit.
    DEEPVISION_EPOCH_CACHE_MAX_BYTES wins when set. On the card,
    HBM_BUDGET_FRACTION of its free memory (`torch.cuda.mem_get_info`, in
    place of XLA's `bytes_limit`); on the CPU no limit (host RAM is the
    ceiling there, and the staged loop would save none of it)."""
    env = os.environ.get("DEEPVISION_EPOCH_CACHE_MAX_BYTES")
    if env:
        return int(float(env))
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(HBM_BUDGET_FRACTION * free)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.nbytes


def _spec(x) -> tuple:
    return tuple(x.shape), str(x.dtype)


@dataclasses.dataclass
class DeviceEpochCache:
    """One epoch on the device, ready for the epoch pass: `arrays` is the
    batch tuple stacked along a leading steps axis, (steps, batch, ...)
    each."""
    arrays: Tuple[torch.Tensor, ...]
    steps: int
    examples_per_step: int
    nbytes: int          # bytes staged (the batches' own dtypes)
    stage_secs: float    # wall time of the stack and the copy to the device

    @property
    def n_batch_args(self) -> int:
        return len(self.arrays)


def _replay_then(collected, rest: Iterator) -> Iterator:
    """The fallback stream: the batches already pulled, then the rest of
    the source — the epoch the caller was about to train, intact."""
    yield from collected
    yield from rest


def _stack(column: list, device: torch.device) -> torch.Tensor:
    if isinstance(column[0], torch.Tensor):
        return torch.stack([to_device(x, device) for x in column])
    return to_device(np.stack(column), device)


def build_epoch_cache(batches: Iterable, device: torch.device, *,
                      shuffle: bool = False,
                      max_bytes: Optional[int] = None, name: str = "train"
                      ) -> Tuple[Optional[DeviceEpochCache],
                                 Optional[Iterator]]:
    """Collect one epoch of batches (numpy arrays, or tensors where a
    loader makes them on the card) and stage them on `device`. Returns
    `(cache, None)`, or `(None, fallback_iterator)` when the epoch cannot
    be cached: over the budget, a ragged stream (shapes or dtypes that
    differ from the first batch's) or an empty one. Every fallback emits
    EpochCacheOverflowWarning and the iterator loses no batch.
    `shuffle=True` doubles the accounted bytes: the permutation gathers a
    shuffled copy of the epoch."""
    budget = max_bytes if max_bytes is not None else hbm_budget_bytes(device)
    factor = 2.0 if shuffle else 1.0
    it = iter(batches)
    collected = []
    nbytes = 0
    spec = None
    for b in it:
        b = tuple(x if isinstance(x, torch.Tensor) else np.asarray(x)
                  for x in b)
        bspec = tuple(_spec(x) for x in b)
        if spec is None:
            spec = bspec
        elif bspec != spec:
            warnings.warn(
                f"[{name}] epoch_on_device: batch {len(collected)} has "
                f"shape/dtype {bspec} != first batch {spec} — a ragged "
                f"stream cannot be stacked for the epoch pass; falling "
                f"back to the staged per-batch path (drop_remainder "
                f"pipelines stack cleanly)", EpochCacheOverflowWarning,
                stacklevel=2)
            return None, _replay_then(collected + [b], it)
        nbytes += sum(_nbytes(x) for x in b)
        collected.append(b)
        if budget is not None and nbytes * factor > budget:
            warnings.warn(
                f"[{name}] epoch_on_device: epoch exceeds the device cache "
                f"budget ({nbytes * factor / 1e9:.2f} GB accounted "
                f"{'incl. the shuffle copy ' if shuffle else ''}vs "
                f"{budget / 1e9:.2f} GB) after {len(collected)} batches — "
                f"falling back to the staged per-batch path "
                f"(parallel/prefetch.py)", EpochCacheOverflowWarning,
                stacklevel=2)
            return None, _replay_then(collected, it)
    if not collected:
        warnings.warn(f"[{name}] epoch_on_device: empty epoch stream — "
                      f"nothing to cache", EpochCacheOverflowWarning,
                      stacklevel=2)
        return None, iter(())
    t0 = time.perf_counter()
    arrays = tuple(_stack([b[j] for b in collected], device)
                   for j in range(len(collected[0])))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return DeviceEpochCache(arrays=arrays, steps=len(collected),
                            examples_per_step=int(collected[0][0].shape[0]),
                            nbytes=nbytes,
                            stage_secs=time.perf_counter() - t0), None
