"""Serving metrics: latency quantiles, batching efficiency, padding waste
(port of deepvision_tpu/serve/metrics.py without the Prometheus histograms,
which arrive with `GET /metrics`).

One thread-safe accumulator the batcher feeds per dispatched batch; the
server flushes snapshots onto its metrics stream (core/metrics.py).

- `p50_ms` / `p99_ms`: request latency submit→result over a bounded window.
  The healthy contract is p99 <= max_delay_ms + one max-bucket compute time.
- `p50_queue_ms` / `p99_queue_ms` / `mean_queue_wait_ms` vs
  `mean_dispatch_ms`: latency split into waiting for a batch slot and the
  device dispatch itself.
- `padding_waste`: fraction of dispatched device rows that were padding —
  the price of shape bucketing.
- `mean_batch_fill` / `batches_per_sec` / `images_per_sec`: how well the
  coalescing window converts request concurrency into device batch size.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np


class ServingMetrics:
    """Interval counters (zeroed by `snapshot(reset=True)`, the server's
    periodic flush) and a bounded latency window. All methods are
    thread-safe."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._window = window
        self._reset_locked(time.monotonic())

    def _reset_locked(self, now: float) -> None:
        self._t0 = now
        self._lat: deque = deque(maxlen=self._window)
        self._qwait: deque = deque(maxlen=self._window)
        self._queue_wait_s = 0.0
        self._requests = 0
        self._examples = 0
        self._batches = 0
        self._rows = 0          # device rows dispatched, padding included
        self._dispatch_s = 0.0
        self._shed = 0                 # Overloaded (429)
        self._admission_rejected = 0   # DeadlineUnmeetable (fast 503)
        self._deadline_expired = 0     # accepted, answered 504
        self._dispatch_errors = 0      # engine dispatches that raised

    def observe_batch(self, *, n_real: int, bucket: int, dispatch_s: float,
                      request_latencies_s: Sequence[float],
                      queue_waits_s: Sequence[float]) -> None:
        """One dispatched batch: its real rows, its bucket, the device
        dispatch time and, per request, submit→result latency and
        submit→dispatch-start queue wait."""
        with self._lock:
            self._requests += len(request_latencies_s)
            self._examples += n_real
            self._batches += 1
            self._rows += bucket
            self._dispatch_s += dispatch_s
            self._lat.extend(request_latencies_s)
            self._qwait.extend(queue_waits_s)
            self._queue_wait_s += sum(queue_waits_s)

    def _bump(self, attr: str) -> None:
        with self._lock:
            setattr(self, attr, getattr(self, attr) + 1)

    def observe_shed(self) -> None:
        """A request rejected by backpressure (`Overloaded`, HTTP 429)."""
        self._bump("_shed")

    def observe_admission_reject(self) -> None:
        """A request refused at the door because its deadline was
        unmeetable (fast 503 + Retry-After)."""
        self._bump("_admission_rejected")

    def observe_deadline_expired(self) -> None:
        """An ACCEPTED request whose result did not arrive by its deadline
        (HTTP 504)."""
        self._bump("_deadline_expired")

    def observe_dispatch_error(self) -> None:
        """A device dispatch raised (the whole batch got the exception)."""
        self._bump("_dispatch_errors")

    def snapshot(self, queue_depth: Optional[int] = None,
                 reset: bool = False) -> dict:
        """Metric dict (floats only). `reset=True` zeroes the interval
        counters afterwards, making consecutive snapshots per-interval
        rates (the server's periodic flush; /stats leaves them alone)."""
        with self._lock:
            now = time.monotonic()
            dt = max(now - self._t0, 1e-9)
            out = {
                "requests": float(self._requests),
                "images_per_sec": self._examples / dt,
                "batches_per_sec": self._batches / dt,
                "mean_batch_fill": (self._examples / self._batches
                                    if self._batches else 0.0),
                "padding_waste": ((self._rows - self._examples) / self._rows
                                  if self._rows else 0.0),
                "mean_dispatch_ms": (1000.0 * self._dispatch_s / self._batches
                                     if self._batches else 0.0),
                "mean_queue_wait_ms": (1000.0 * self._queue_wait_s
                                       / self._requests
                                       if self._requests else 0.0),
                "shed_requests": float(self._shed),
                "admission_rejected": float(self._admission_rejected),
                "deadline_expired": float(self._deadline_expired),
                "dispatch_errors": float(self._dispatch_errors),
            }
            if self._lat:
                lat_ms = np.asarray(self._lat, np.float64) * 1000.0
                out["p50_ms"] = float(np.percentile(lat_ms, 50))
                out["p99_ms"] = float(np.percentile(lat_ms, 99))
            if self._qwait:
                qw_ms = np.asarray(self._qwait, np.float64) * 1000.0
                out["p50_queue_ms"] = float(np.percentile(qw_ms, 50))
                out["p99_queue_ms"] = float(np.percentile(qw_ms, 99))
            if queue_depth is not None:
                out["queue_depth"] = float(queue_depth)
            if reset:
                self._reset_locked(now)
        return out
