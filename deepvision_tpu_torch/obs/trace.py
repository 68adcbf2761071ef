"""Span tracing: follow one request (or one training step) through the
stack (port of deepvision_tpu/obs/trace.py, the same sampling and the
same span records).

A `Tracer` records completed spans — `(name, category, start_ns, dur_ns,
thread, args)` dicts — into a bounded ring buffer under one lock. Nothing
is written to disk on the hot path; export (obs/export.py) walks the ring
on demand (`GET /trace` on the serve server, `--trace-out` on trainers).

Cost: a DISABLED tracer is one attribute check per call site (every
producer guards with ``tr is not None and tr.enabled``, or calls
`request_context`, which returns None at once). An ENABLED tracer samples
per request: `request_context` hands out a `TraceContext` for 1-in-N
requests (`sample`, default DEEPVISION_TRACE_SAMPLE=0.1) and None for the
rest, so an unsampled request records no span. A client-supplied
`X-Request-Id` forces sampling (`forced=True`): the request an operator
chases always leaves its spans. Batch-level spans (one per dispatch) are
recorded whenever tracing is enabled.

Every HTTP request gets a `request_id` (the client's `X-Request-Id` or
`new_request_id()`), echoed in every response and stamped into its spans'
args, so the chain http_request → admission → queue_wait → batch →
device_dispatch → response_write and any `resilience_` event the request
triggered (`request_id` / `trace_ref` fields) join on one key.

Clock: `time.monotonic_ns()`, the CLOCK_MONOTONIC of the batcher's
`time.monotonic()` timestamps.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Optional

# default per-request sampling rate: 1-in-10 requests fully traced
DEFAULT_SAMPLE = float(os.environ.get("DEEPVISION_TRACE_SAMPLE", "0.1"))

_RID_SEQ = itertools.count(1)


def new_request_id() -> str:
    """Process-unique request id for requests that didn't bring their own
    `X-Request-Id`: short enough to read in a log line, unique enough to
    join across serve.jsonl, /trace, and a client's own records."""
    return f"r{next(_RID_SEQ)}-{uuid.uuid4().hex[:8]}"


class TraceContext:
    """A sampled request's trace handle, threaded submit→dispatch→response.

    `root_id` is allocated at sampling time (before the root span is
    recorded) so refusal paths can stamp a stable `trace_ref`
    (``span:<root_id>``) into the resilience event they log even though
    the http_request span itself is only recorded when the response goes
    out."""

    __slots__ = ("tracer", "request_id", "root_id")

    def __init__(self, tracer: "Tracer", request_id: str, root_id: int):
        self.tracer = tracer
        self.request_id = request_id
        self.root_id = root_id

    @property
    def trace_ref(self) -> str:
        return f"span:{self.root_id}"


class Tracer:
    """Thread-safe ring-buffered span recorder.

    `capacity` bounds memory (oldest spans fall off — /trace?secs=N is a
    recent-history window by design); `sample` is the per-request
    sampling rate (see module docstring); `enabled=False` turns every
    entry point into a cheap no-op so a single constructor flag is the
    whole kill switch."""

    def __init__(self, capacity: int = 16384, sample: Optional[float] = None,
                 enabled: bool = True):
        self.enabled = bool(enabled)
        self.sample = DEFAULT_SAMPLE if sample is None else float(sample)
        if not 0.0 <= self.sample <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {self.sample}")
        # deterministic 1-in-N sampling (counter, not RNG): reproducible in
        # tests, and the rate is exact rather than merely expected
        self._every = (int(round(1.0 / self.sample)) if self.sample > 0
                       else 0)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._req_count = itertools.count(0)
        self.recorded = 0          # lifetime spans recorded (ring may drop)
        # export anchors: monotonic origin + the wall-clock instant it maps
        # to, so exported traces can be lined up with JSONL timestamps
        self.t0_ns = time.monotonic_ns()
        self.t0_unix = time.time()

    # -- context -----------------------------------------------------------

    def new_id(self) -> int:
        return next(self._ids)

    def request_context(self, request_id: Optional[str] = None, *,
                        forced: bool = False) -> Optional[TraceContext]:
        """Sampling decision for one request: a `TraceContext` when this
        request's spans should be recorded, None otherwise (disabled
        tracer, or not this request's turn). `forced=True` (client
        brought an explicit X-Request-Id) always samples."""
        if not self.enabled:
            return None
        if not forced:
            if self._every == 0:
                return None
            if next(self._req_count) % self._every != 0:
                return None
        return TraceContext(self, request_id or new_request_id(),
                            self.new_id())

    # -- recording ---------------------------------------------------------

    def add(self, name: str, cat: str, start_ns: int, dur_ns: int, *,
            args: Optional[dict] = None, span_id: Optional[int] = None,
            tid: Optional[str] = None) -> int:
        """Record one completed span; returns its id (for linkage args).
        A disabled tracer records nothing and returns 0."""
        if not self.enabled:
            return 0
        sid = span_id if span_id is not None else self.new_id()
        span = {"id": sid, "name": name, "cat": cat,
                "ts": int(start_ns), "dur": max(0, int(dur_ns)),
                "tid": tid or threading.current_thread().name,
                "args": args or {}}
        with self._lock:
            self._spans.append(span)
            self.recorded += 1
        return sid

    @contextmanager
    def span(self, name: str, cat: str = "serve", **args):
        """Record the wrapped block as one span; yields a mutable args dict
        (extra tags set inside the block land on the span)."""
        if not self.enabled:
            yield args
            return
        t0 = time.monotonic_ns()
        try:
            yield args
        finally:
            self.add(name, cat, t0, time.monotonic_ns() - t0, args=args)

    # -- reading -----------------------------------------------------------

    def spans(self, since_s: Optional[float] = None) -> list:
        """Snapshot of the ring, oldest first; `since_s` keeps only spans
        that ENDED within the last `since_s` seconds."""
        with self._lock:
            items = list(self._spans)
        if since_s is not None:
            cutoff = time.monotonic_ns() - int(since_s * 1e9)
            items = [s for s in items if s["ts"] + s["dur"] >= cutoff]
        return items
