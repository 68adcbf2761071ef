"""Serving metrics: latency quantiles, batching efficiency, padding waste
(port of deepvision_tpu/serve/metrics.py).

One thread-safe accumulator the batcher feeds per dispatched batch; the
server flushes snapshots onto its metrics stream (core/metrics.py) and
renders the lifetime counters and histograms on `GET /metrics`
(obs/export.py).

- `p50_ms` / `p99_ms`: request latency submit→result over a bounded window.
  The healthy contract is p99 <= max_delay_ms + one max-bucket compute time.
- `p50_queue_ms` / `p99_queue_ms` / `mean_queue_wait_ms` vs
  `mean_dispatch_ms`: latency split into waiting for a batch slot and the
  device dispatch itself; when the p99 bound is blown, the split says
  whether the cure is workers or shedding (queue-dominated) or a smaller
  bucket or model (dispatch-dominated).
- `padding_waste`: fraction of dispatched device rows that were padding —
  the price of shape bucketing.
- `mean_batch_fill` / `batches_per_sec` / `images_per_sec`: how well the
  coalescing window converts request concurrency into device batch size.
- `totals()`: lifetime counters (requests, examples, sheds, admission
  refusals, expiries, breaker refusals, dispatch and observer errors),
  never reset: the autoscaler samples their deltas and `/metrics` renders
  them as counters. `histograms()` / `histograms_by_precision()`: lifetime
  fixed-bucket (`LATENCY_BUCKETS_S`) latency, queue-wait and dispatch
  histograms, Prometheus histograms on `/metrics`.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Optional, Sequence

import numpy as np

# fixed histogram buckets (seconds): spans 1ms (the coalescing floor) to
# 10s (the serve CLI's default deadline); values past the last edge land in
# the implicit +Inf bucket. Fixed — not adaptive — so scrapes from every
# replica aggregate, the whole point of exposition histograms.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _Histogram:
    """Lifetime fixed-bucket histogram (Prometheus semantics): per-bucket
    counts plus sum/count, NEVER reset — rendered cumulatively with a +Inf
    bucket by `render()`. Callers hold the owning ServingMetrics lock."""

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float] = LATENCY_BUCKETS_S):
        self.edges = tuple(edges)
        self.counts = [0] * (len(self.edges) + 1)   # last = > max edge
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    def render(self) -> dict:
        """{"buckets": [(le, cumulative_count), ..., (inf, count)],
        "sum": float, "count": int} — the exposition shape."""
        cum, buckets = 0, []
        for le, n in zip(self.edges, self.counts):
            cum += n
            buckets.append((le, cum))
        buckets.append((float("inf"), self.count))
        return {"buckets": buckets, "sum": self.sum, "count": self.count}


class ServingMetrics:
    """Cumulative counters since construction (or the last reset) plus a
    bounded latency window. All methods are thread-safe.

    Two horizons: the interval counters (zeroed by `snapshot(reset=True)`,
    the server's periodic flush) and the LIFETIME totals (`totals()`, never
    reset) — the autoscale control loop samples deltas of the totals, so
    its shed/overload evidence cannot be erased out from under it by a
    concurrent metrics flush."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._window = window
        # lifetime totals — survive every reset (autoscaler's sample source)
        self._totals = {"requests": 0, "examples": 0, "shed": 0,
                        "admission_rejected": 0, "deadline_expired": 0,
                        "breaker_rejected": 0, "dispatch_errors": 0,
                        "observer_errors": 0}
        # lifetime fixed-bucket histograms (never reset — /metrics renders
        # them as Prometheus histograms, which must be monotone per scrape),
        # keyed {name: {precision: _Histogram}}: batches of each precision
        # land in their own labeled series, so a precision flip (int8,
        # when quantized serving lands) shows in the scrape
        self._hist = {"request_latency_seconds": {},
                      "queue_wait_seconds": {},
                      "dispatch_seconds": {}}
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
        self._shed = 0          # requests rejected at the door (Overloaded)
        # overload-control interval counters: refusals at the door by
        # kind, plus failure evidence
        self._admission_rejected = 0   # DeadlineUnmeetable (fast 503)
        self._deadline_expired = 0     # accepted, answered 504 past deadline
        self._breaker_rejected = 0     # CircuitOpen fail-fast 503
        self._dispatch_errors = 0      # engine dispatches that raised
        self._observer_errors = 0      # per-batch observer tap exceptions

    def _hist_for(self, name: str, precision: str) -> _Histogram:
        by_precision = self._hist[name]
        h = by_precision.get(precision)
        if h is None:
            h = by_precision[precision] = _Histogram()
        return h

    def observe_batch(self, *, n_real: int, bucket: int, dispatch_s: float,
                      request_latencies_s: Sequence[float],
                      queue_waits_s: Optional[Sequence[float]] = None,
                      precision: str = "bf16") -> None:
        """One dispatched batch. `queue_waits_s` (per request, submit
        acceptance -> dispatch start) separates the queueing component of
        latency from `dispatch_s` (the device's share) — the two used to be
        conflated inside the submit->result latencies, leaving the p99
        bound unable to say WHERE a blown deadline went. `precision` labels
        the histogram series the batch lands in (the engine precision its
        dispatch ran at; the full-precision rung is "bf16")."""
        with self._lock:
            self._requests += len(request_latencies_s)
            self._examples += n_real
            self._batches += 1
            self._rows += bucket
            self._dispatch_s += dispatch_s
            self._lat.extend(request_latencies_s)
            self._totals["requests"] += len(request_latencies_s)
            self._totals["examples"] += n_real
            self._hist_for("dispatch_seconds", precision).observe(dispatch_s)
            lat_h = self._hist_for("request_latency_seconds", precision)
            for lat in request_latencies_s:
                lat_h.observe(lat)
            if queue_waits_s is not None:
                self._qwait.extend(queue_waits_s)
                qw_h = self._hist_for("queue_wait_seconds", precision)
                for qw in queue_waits_s:
                    self._queue_wait_s += qw
                    qw_h.observe(qw)

    def observe_shed(self, n_requests: int = 1) -> None:
        """Count a request rejected by backpressure (`Overloaded`, HTTP
        429). Shed rate = shed / (requests + shed) is the third number of
        the load contract next to sustained QPS and p99 under load: a
        server meeting its p99 by shedding half its offered traffic is not
        meeting anything."""
        with self._lock:
            self._shed += n_requests
            self._totals["shed"] += n_requests

    def _bump(self, interval_attr: str, total_key: str) -> None:
        with self._lock:
            setattr(self, interval_attr, getattr(self, interval_attr) + 1)
            self._totals[total_key] += 1

    def observe_admission_reject(self) -> None:
        """A request refused at the door because the dispatch-time EMA x
        queue depth said its deadline was unmeetable (fast 503 +
        Retry-After) — overload evidence for the autoscaler, same as shed."""
        self._bump("_admission_rejected", "admission_rejected")

    def observe_deadline_expired(self) -> None:
        """An ACCEPTED request whose result did not arrive by its deadline
        (HTTP 504): the admission estimate was too optimistic, or a
        dispatch stalled."""
        self._bump("_deadline_expired", "deadline_expired")

    def observe_breaker_reject(self) -> None:
        """A request failed fast because the model's circuit is open."""
        self._bump("_breaker_rejected", "breaker_rejected")

    def observe_dispatch_error(self) -> None:
        """A device dispatch raised (the whole batch's futures got the
        exception) — the circuit breaker's failure evidence."""
        self._bump("_dispatch_errors", "dispatch_errors")

    def observe_observer_error(self) -> None:
        """The per-batch observer tap raised — counted, never silent
        (each distinct error also gets one resilience event)."""
        self._bump("_observer_errors", "observer_errors")

    def totals(self) -> dict:
        """Lifetime counters, NEVER reset — the autoscale control loop
        samples deltas of these so a concurrent `snapshot(reset=True)`
        (the server's periodic flush) cannot zero its evidence window."""
        with self._lock:
            return dict(self._totals)

    def histograms(self) -> dict:
        """Lifetime latency/queue-wait/dispatch histograms AGGREGATED over
        precisions, in exposition shape ({name: {"buckets": [(le, cum)],
        "sum", "count"}}) — never reset, so scrapes are monotone."""
        with self._lock:
            out = {}
            for name, by_precision in self._hist.items():
                agg = _Histogram()
                for h in by_precision.values():
                    for i, n in enumerate(h.counts):
                        agg.counts[i] += n
                    agg.sum += h.sum
                    agg.count += h.count
                out[name] = agg.render()
            return out

    def histograms_by_precision(self) -> dict:
        """The labeled view `GET /metrics` renders: {name: {precision:
        exposition dict}} — one Prometheus series per (model, precision),
        so a precision split of dispatch/latency is scrapeable."""
        with self._lock:
            return {name: {p: h.render() for p, h in by_precision.items()}
                    for name, by_precision in self._hist.items()}

    def snapshot(self, queue_depth: Optional[int] = None,
                 reset: bool = False) -> dict:
        """Metric dict (floats only — MetricsLogger-ready). `reset=True`
        zeroes the counters afterwards, making consecutive snapshots
        per-interval rates (the server's periodic flush; /stats leaves the
        counters alone)."""
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
                # queueing share of latency (submit accept -> dispatch
                # start), distinct from the device's mean_dispatch_ms
                "mean_queue_wait_ms": (1000.0 * self._queue_wait_s
                                       / self._requests
                                       if self._requests else 0.0),
                "shed_requests": float(self._shed),
                "admission_rejected": float(self._admission_rejected),
                "deadline_expired": float(self._deadline_expired),
                "breaker_rejected": float(self._breaker_rejected),
                "dispatch_errors": float(self._dispatch_errors),
                "observer_errors": float(self._observer_errors),
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
