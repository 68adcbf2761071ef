"""Host -> device batch staging on a producer thread (own copy of
deepvision_tpu/parallel/prefetch.py: `DevicePrefetcher`,
`prefetch_to_device`).

A daemon producer thread pulls host batches (tuples of numpy arrays) and
stages them on the device up to `size` batches ahead, so generating and
copying batch i + 1 overlaps the step on batch i. On a CUDA device each
array goes through a pinned host buffer and a `non_blocking` copy on a side
stream; the consumer's stream waits on the copy's event before it uses the
batch, and `record_stream` tells the caching allocator that the consumer's
stream uses the staged tensors, so their memory is not handed to the side
stream again while the step still reads it. A pinned buffer is reused only
after its copy's event has completed. On the CPU a batch is staged without
pinning. A tensor that already lies on `device` (a batch the record
loaders decoded on the card) passes through unstaged: no copy, 0 bytes
in the ledger; on the card an event on the producer's current stream
still orders it before the consumer's use. `size <= 1` stages inline, in
the consumer's thread. Staging runs
with `device` as the current card, so a rank of a data-parallel run puts
its side stream, events and pinned buffers on its own card, whatever
card the calling thread has current.

The transfer ledger (read from any thread; plain int and float writes):
- `bytes_staged_total`: host bytes staged so far (a uint8 batch counts a
  quarter of the same batch in f32);
- `last_stage_secs`: wall time of the last batch's stage (pinned copy, H2D
  copy and its completion; not the host generator);
- `bytes_per_sec`: staged bytes over the summed stage time;
- `wait_secs_total`, `first_wait_secs`, `overlapped_fraction`: how long the
  consumer waited for staged batches, how much of that was the first wait
  (the pipeline fill, which nothing can overlap), and the share of staging
  time hidden under the consumer's work in steady state,
  max(0, 1 - (wait - first_wait) / stage time). Inline staging is all
  wait: its fraction is 0. The steady wait also counts time blocked on a
  slow host generator, so a low fraction means "the consumer waited";
- `queue_depth`: staged batches waiting (size - 1 while the consumer is the
  slower side, 0 while the host is).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

_SENTINEL = object()


class _ProducerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class _PinnedPool:
    """Pinned host buffers per (shape, dtype), each with the event of the
    last copy out of it: a buffer is handed out again only once that event
    has completed, so a pending H2D copy never reads a refilled buffer."""

    def __init__(self):
        self._free: Dict[Tuple, List[Tuple[torch.Tensor, torch.cuda.Event]]] \
            = {}

    def take(self, shape, dtype) -> torch.Tensor:
        for i, (buf, event) in enumerate(self._free.get((shape, dtype), [])):
            if event.query():
                del self._free[(shape, dtype)][i]
                return buf
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def give(self, buf: torch.Tensor, event: torch.cuda.Event) -> None:
        self._free.setdefault((tuple(buf.shape), buf.dtype), []).append(
            (buf, event))


class DevicePrefetcher:
    """Iterator of device-staged batches (tuples of tensors on `device`),
    staged up to `size` ahead. Producer exceptions re-raise at the
    consumer's `next()`; `close()` stops the producer and drops what it
    staged. At most `size` staged batches exist beyond the one the
    consumer holds."""

    def __init__(self, batches: Iterable, size: int = 2,
                 device: Optional[torch.device] = None):
        self.device = torch.device("cpu" if device is None else device)
        self.bytes_staged_total = 0
        self.batches_staged_total = 0
        self.last_stage_secs = 0.0
        self.wait_secs_total = 0.0
        self.first_wait_secs = 0.0
        self._stage_secs_total = 0.0
        self._first_wait_seen = False
        self._stop = threading.Event()
        self._cuda = self.device.type == "cuda"
        self._stream = None
        self._pool = _PinnedPool() if self._cuda else None
        self._inline: Optional[Iterator] = None
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if size <= 1:
            self._inline = iter(batches)
            return
        self._q = queue.Queue(maxsize=size - 1)
        self._batches = batches
        self._thread = threading.Thread(target=self._producer, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    @property
    def queue_depth(self) -> int:
        return self._q.qsize() if self._q is not None else 0

    @property
    def bytes_per_sec(self) -> float:
        if self._stage_secs_total <= 0.0:
            return 0.0
        return self.bytes_staged_total / self._stage_secs_total

    @property
    def overlapped_fraction(self) -> float:
        if self._stage_secs_total <= 0.0:
            return 0.0
        steady = self.wait_secs_total - self.first_wait_secs
        return max(0.0, 1.0 - steady / self._stage_secs_total)

    def ledger(self) -> Dict[str, float]:
        """A snapshot of the transfer ledger."""
        return {"bytes_staged_total": self.bytes_staged_total,
                "batches_staged_total": self.batches_staged_total,
                "last_stage_secs": self.last_stage_secs,
                "bytes_per_sec": self.bytes_per_sec,
                "wait_secs_total": self.wait_secs_total,
                "first_wait_secs": self.first_wait_secs,
                "overlapped_fraction": self.overlapped_fraction,
                "queue_depth": self.queue_depth}

    def _on_device(self, array) -> bool:
        return (isinstance(array, torch.Tensor)
                and array.device.type == self.device.type
                and (not self._cuda or array.device == self.device))

    def _to_device(self, array) -> torch.Tensor:
        if self._on_device(array):
            return array
        host = torch.as_tensor(np.asarray(array))
        if not self._cuda:
            return host.to(self.device)
        pinned = self._pool.take(tuple(host.shape), host.dtype)
        pinned.copy_(host)
        with torch.cuda.stream(self._stream):
            staged = pinned.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._pool.give(pinned, event)
        return staged

    def _stage(self, batch) -> tuple:
        """(tensors on the device, the copies' event or None), with the
        ledger updated around it."""
        nbytes = sum(int(np.asarray(a).nbytes) for a in batch
                     if not self._on_device(a))
        t0 = time.perf_counter()
        with (torch.cuda.device(self.device) if self._cuda
              else contextlib.nullcontext()):
            if self._cuda and self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            staged = tuple(self._to_device(a) for a in batch)
            event = None
            if self._cuda:
                event = torch.cuda.Event()
                if all(self._on_device(a) for a in batch):
                    # nothing copied: order after the loader's own work
                    event.record(torch.cuda.current_stream(self.device))
                else:
                    event.record(self._stream)
                    event.synchronize()  # the stage includes the transfer
        dt = time.perf_counter() - t0
        self.bytes_staged_total += nbytes
        self.batches_staged_total += 1
        self.last_stage_secs = dt
        self._stage_secs_total += dt
        return staged, event

    def _put(self, item) -> bool:
        """A blocking put that still observes stop; True if delivered."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        try:
            for batch in self._batches:
                if self._stop.is_set():
                    return
                if not self._put(self._stage(batch)):
                    return
        except BaseException as e:  # re-raised in the consumer
            self._put(_ProducerError(e))
            return
        self._put(_SENTINEL)

    def _hand_over(self, item) -> tuple:
        """The consumer's side of a staged batch: its stream waits on the
        copies, and the allocator learns that this stream uses them."""
        staged, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in staged:
                t.record_stream(stream)
        return staged

    def __iter__(self) -> Iterator[tuple]:
        return self

    def __next__(self) -> tuple:
        if self._inline is not None:
            item = self._stage(next(self._inline))
            self.wait_secs_total += self.last_stage_secs
            return self._hand_over(item)
        if self._q is None or self._stop.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        wait = time.perf_counter() - t0
        if not self._first_wait_seen:
            self._first_wait_seen = True
            self.first_wait_secs = wait
        self.wait_secs_total += wait
        if item is _SENTINEL:
            self._stop.set()
            raise StopIteration
        if isinstance(item, _ProducerError):
            self._stop.set()
            raise item.exc
        return self._hand_over(item)

    def close(self, timeout: float = 60.0) -> None:
        """Stop the producer, drop the batches it staged and join it."""
        self._stop.set()
        if self._inline is not None:
            close = getattr(self._inline, "close", None)
            if close is not None:
                close()
            self._inline = None
            return
        if self._thread is None:
            return
        self._drain()
        self._thread.join(timeout)
        self._drain()

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def prefetch_to_device(batches: Iterable, size: int = 2,
                       device: Optional[torch.device] = None
                       ) -> DevicePrefetcher:
    """A DevicePrefetcher over `batches` (see the class)."""
    return DevicePrefetcher(batches, size, device)
