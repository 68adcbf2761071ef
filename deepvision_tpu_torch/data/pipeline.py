"""The skeleton the port's TFRecord pipelines share (ImageNet, detection,
pose, CycleGAN): the rank's files in the JAX pipelines' order, records
read, parsed and shuffled on the host, batches decoded and resampled on
the device.

Order. Eval reads the sorted files of the rank's shard, through
`interleave(cycle_length=16, block_length=16)` for ImageNet
(deepvision_tpu/data/imagenet.py:164-167) or file after file for the
others (`TFRecordDataset(files)`, one file at a time where JAX reads with
`num_parallel_reads`: the same order for one file). Training shuffles the
files and the records (a buffer of `shuffle_buffer`, as `Dataset.shuffle`)
with the port's generator, seeded from (seed, epoch, rank): TensorFlow's
shuffles cannot be reproduced, and its contract is what the tests hold.

Device. On a CUDA device the decode and the resample run on a stream of
the pipeline's own, so they overlap the step on the default stream; the
producer waits for its batch before handing it over, and the batch's
tensors are recorded on the caller's current stream for the caching
allocator. Every tensor of a batch lies on the device, labels and boxes
included, so the prefetcher passes it through with 0 bytes staged; the
host-to-device bytes are the compressed streams (`jpeg.stats`) plus the
per-image descriptors and labels.
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from . import records
from .jpeg import host_crc32c


class RecordPipeline:
    """Batches of one split of TFRecord files. Subclasses give `parse`
    (serialized Example → item) and `make_batch` (items, generator →
    tuple of tensors on the device)."""

    cycle_length: Optional[int] = None   # interleave, None: file by file
    block_length: int = 16

    def __init__(self, file_pattern: str, *, batch_size: int,
                 training: bool, seed: int = 0, num_process: int = 1,
                 process_index: int = 0, shuffle_buffer: int = 512,
                 drop_remainder: bool = True, repeat: bool = False,
                 cache: bool = False, device="cpu"):
        self.device = torch.device(device)
        self.files = records.list_files(file_pattern, training=training,
                                        seed=seed, world=num_process,
                                        rank=process_index)
        self.batch_size = batch_size
        self.training = training
        self.seed = seed
        self.rank = process_index
        self.shuffle_buffer = shuffle_buffer
        self.drop_remainder = drop_remainder
        self.repeat = repeat and training
        # eval: the records of the first whole pass, replayed after it
        # (`Dataset.cache()` before the map)
        self.cache = cache and not training
        self._cached: Optional[List[bytes]] = None
        self._crc = host_crc32c(self.device)
        self._stream = side_stream(self.device)
        self.epoch = 0

    # -- subclass hooks ------------------------------------------------------
    def parse(self, serialized: bytes):
        raise NotImplementedError

    def make_batch(self, items: Sequence, rng: np.random.Generator) -> tuple:
        raise NotImplementedError

    # -- the record stream ---------------------------------------------------
    def _read(self, path: str) -> Iterator[bytes]:
        return records.read_records(path, crc=self._crc)

    def _one_pass(self, files: Sequence[str]) -> Iterator[bytes]:
        if self.cycle_length:
            return records.interleave(files, cycle_length=self.cycle_length,
                                      block_length=self.block_length,
                                      reader=self._read)
        return itertools.chain.from_iterable(self._read(f) for f in files)

    def _records(self, rng: np.random.Generator) -> Iterator[bytes]:
        """Pass after pass (one unless repeating), each shuffled on its
        own in training: `shuffle(buffer).repeat()`, the JAX order."""
        passes = itertools.count() if self.repeat else range(1)
        for _ in passes:
            files = self.files
            if self.cache and self._cached is not None:
                yield from self._cached
                continue
            if self.cache:
                seen = []
                for rec in self._one_pass(files):
                    seen.append(rec)
                    yield rec
                self._cached = seen     # kept once a pass is whole
                continue
            if not self.training:
                yield from self._one_pass(files)
                continue
            if len(files) > 1:
                files = [files[i] for i in rng.permutation(len(files))]
            yield from records.shuffle_buffer(self._one_pass(files),
                                              self.shuffle_buffer, rng)

    def rng(self, epoch: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, epoch, self.rank])

    def batches(self, epoch: Optional[int] = None) -> Iterator[tuple]:
        """One epoch's batches (endless for a repeating training set);
        `epoch` defaults to a counter bumped per call."""
        if epoch is None:
            epoch, self.epoch = self.epoch, self.epoch + 1
        rng = self.rng(epoch)
        items: List = []
        for rec in self._records(rng):
            items.append(self.parse(rec))
            if len(items) == self.batch_size:
                yield self._run(items, rng)
                items = []
        if items and not self.drop_remainder:
            yield self._run(items, rng)

    __iter__ = batches

    def _run(self, items: Sequence, rng: np.random.Generator) -> tuple:
        return on_side_stream(self._stream, self.device,
                              lambda: self.make_batch(items, rng))

    def to_device(self, array, dtype=None) -> torch.Tensor:
        """A host array as a tensor on the pipeline's device."""
        t = torch.as_tensor(np.asarray(array), dtype=dtype)
        return t.to(self.device, non_blocking=False)


def side_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    """A loader's own stream on a card (None on the CPU)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on_side_stream(stream: Optional[torch.cuda.Stream], device,
                   make: Callable[[], tuple]) -> tuple:
    """`make()`'s batch, built on `stream` when there is one: the caller
    waits for it (the batch is whole, and the compressed streams it held
    may go), and its tensors are recorded on the caller's current stream,
    which uses them next."""
    if stream is None:
        return make()
    current = torch.cuda.current_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        batch = make()
    stream.synchronize()
    for t in batch:
        t.record_stream(current)
    return batch


def epoch_iterator(ds: RecordPipeline, steps: Optional[int] = None,
                   epoch: Optional[int] = None) -> Iterator[tuple]:
    """`ds`'s batches, bounded to `steps` (the JAX package's
    `epoch_iterator`; a repeating training set needs the bound)."""
    it = ds.batches(epoch)
    return itertools.islice(it, steps) if steps is not None else it
