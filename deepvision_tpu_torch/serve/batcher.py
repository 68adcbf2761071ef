"""Dynamic micro-batching: coalesce concurrent requests into one dispatch
(port of deepvision_tpu/serve/batcher.py; span tracing, fault injection,
the per-batch observer tap, weight generations, the circuit breaker and the
autoscaled worker pool arrive with the features that use them).

Concurrent `submit()` calls land in a thread-safe queue; one dispatcher
thread per model coalesces them up to `max_batch` examples
or until the OLDEST request's `max_delay_ms` deadline expires — whichever
comes first — runs one engine dispatch (padded to the nearest bucket), and
scatters the per-request output slices back through
`concurrent.futures.Future`s. Every request lives in exactly one batch.

Overload control at the door (`submit` refuses BEFORE accepting — nothing
partial ever happens):

- `Overloaded` (HTTP 429): once `max_queue_examples` are pending, shed
  instead of building an unbounded latency queue.
- `DeadlineUnmeetable` (HTTP 503 + Retry-After): when the dispatch-time EMA
  x queued batches says the answer cannot arrive in time, refuse NOW.
- `Draining` (HTTP 503): shutting down; in-flight batches finish.

`result_within()` is the deadline-bounded wait every caller of a submit
future uses: a wedged dispatch answers `DeadlineExpired` (HTTP 504) in
bounded time.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import List, Optional

import numpy as np

from .engine import PredictEngine, pick_bucket, tree_slice


class RequestRejected(RuntimeError):
    """Base: the request was NOT accepted — nothing partial happened."""


class Overloaded(RequestRejected):
    """Pending examples >= max_queue_examples — shed load upstream (429)."""


class Draining(RequestRejected):
    """Shutting down: in-flight batches finish, new work is rejected (503)."""


class DeadlineUnmeetable(RequestRejected):
    """Admission control refused at the door: the dispatch-time EMA x
    queued batches says the result cannot arrive inside the request's
    deadline (HTTP 503 + Retry-After `retry_after_s`)."""

    def __init__(self, msg: str, *, eta_s: float, deadline_s: float,
                 retry_after_s: float):
        super().__init__(msg)
        self.eta_s = eta_s
        self.deadline_s = deadline_s
        self.retry_after_s = retry_after_s


class DeadlineExpired(TimeoutError):
    """An ACCEPTED request's result did not arrive by its deadline (HTTP
    504). The work may still complete on the device — only the waiter gave
    up."""


def result_within(future: Future, deadline_s: Optional[float], *,
                  what: str = "request"):
    """Deadline-bounded `future.result()`: raises `DeadlineExpired` after
    `deadline_s` (None = wait forever — explicit opt-in, never a default)."""
    try:
        return future.result(timeout=deadline_s)
    except _FutureTimeout:
        raise DeadlineExpired(
            f"{what} deadline of {deadline_s:g}s expired before a result "
            f"arrived — the model is wedged or the queue estimate was "
            f"optimistic; retry with a longer deadline or another replica"
        ) from None


class _Request:
    __slots__ = ("images", "n", "future", "t_submit")

    def __init__(self, images: np.ndarray):
        self.images = images
        self.n = images.shape[0]
        self.future: Future = Future()
        self.t_submit = time.monotonic()


def _settle(fut: Future, result=None, exc: Optional[BaseException] = None):
    """Deliver ignoring client-side cancellation races."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass  # client cancelled/abandoned the future — nothing to deliver


class DynamicBatcher:
    """Thread-safe request queue + one dispatcher thread over an engine.

    `submit(images) -> Future` accepts `(n, *example_shape)` with
    `1 <= n <= max_batch` (or one bare example); the future resolves to the
    output rows of exactly those n examples, in order. `default_deadline_s`
    arms admission control for submits that don't carry their own deadline
    (None = every request admitted regardless of the queue).
    """

    def __init__(self, engine: PredictEngine, *,
                 max_batch: Optional[int] = None,
                 max_delay_ms: float = 5.0,
                 max_queue_examples: int = 1024,
                 metrics=None,
                 default_deadline_s: Optional[float] = None):
        if max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0, got {max_delay_ms}")
        self.engine = engine
        self.max_batch = min(int(max_batch or engine.max_batch),
                             engine.max_batch)
        self.max_delay = max_delay_ms / 1000.0
        self.max_queue_examples = int(max_queue_examples)
        self.metrics = metrics
        self.default_deadline_s = default_deadline_s
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._pending = 0          # examples accepted, results not yet set
        self._draining = False
        # EMA of per-batch dispatch wall time — the admission controller's
        # service-time estimate (0 until the first dispatch: no evidence,
        # every deadline admitted)
        self._dispatch_ema_s = 0.0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"dispatch-{engine.name}")
        self._thread.start()

    @property
    def queue_depth(self) -> int:
        """Examples accepted whose results are not yet delivered."""
        with self._lock:
            return self._pending

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    # -- client side -------------------------------------------------------

    def submit(self, images, *, deadline_s: Optional[float] = None) -> Future:
        x = self.engine._coerce(images)
        n = x.shape[0]
        if n > self.max_batch:
            raise ValueError(
                f"request of {n} examples exceeds max_batch="
                f"{self.max_batch}; split client batches")
        dl = deadline_s if deadline_s is not None else self.default_deadline_s
        with self._lock:
            if self._draining:
                raise Draining(
                    "server is draining: in-flight batches are finishing, "
                    "new work is rejected — retry against another replica")
            if self._pending + n > self.max_queue_examples:
                if self.metrics is not None:
                    self.metrics.observe_shed()
                raise Overloaded(
                    f"queue full ({self._pending} examples pending, cap "
                    f"{self.max_queue_examples}) — shed load or raise "
                    f"max_queue_examples")
            if dl is not None:
                eta = self._eta_locked(n)
                if eta > dl:
                    # Retry-After ~= time for the current backlog to clear
                    retry = max(0.001, eta - self.max_delay
                                - self._dispatch_ema_s)
                    if self.metrics is not None:
                        self.metrics.observe_admission_reject()
                    raise DeadlineUnmeetable(
                        f"deadline {dl * 1000:g}ms unmeetable: estimated "
                        f"completion in {eta * 1000:.1f}ms "
                        f"({self._pending} examples queued, dispatch EMA "
                        f"{self._dispatch_ema_s * 1000:.1f}ms) — refused at "
                        f"the door so you can retry elsewhere",
                        eta_s=eta, deadline_s=dl, retry_after_s=retry)
            self._pending += n
            # enqueued under the lock: drain() flips `_draining` under it
            # before its stop token, so no accepted request can land behind
            # the token and go unanswered
            req = _Request(x)
            self._q.put(req)
        return req.future

    def _eta_locked(self, n: int) -> float:
        """Expected submit->result time for an n-example request arriving
        NOW: the coalescing wait plus (batches ahead of and including it)
        x dispatch EMA. Optimistic when there is no dispatch evidence yet
        (EMA 0 admits everything)."""
        ema = self._dispatch_ema_s
        if ema <= 0.0:
            return 0.0
        batches_ahead = math.ceil((self._pending + n) / self.max_batch)
        return self.max_delay + ema * batches_ahead

    # -- dispatcher --------------------------------------------------------

    def _loop(self) -> None:
        carry: Optional[_Request] = None   # overflow of the last batch
        while True:
            first = carry
            carry = None
            if first is None:
                first = self._q.get()       # idle: block until work or stop
            if first is None:               # stop: everything accepted
                break                       # before it has been dispatched
            batch: List[_Request] = [first]
            total = first.n
            deadline = first.t_submit + self.max_delay
            while total < self.max_batch:
                # Past the deadline, requests ALREADY queued still coalesce
                # (get_nowait) — only waiting for future arrivals stops, so
                # under backlog batches stay full instead of degenerating to
                # size 1 exactly when batching matters most.
                wait = deadline - time.monotonic()
                try:
                    nxt = (self._q.get(timeout=wait) if wait > 0
                           else self._q.get_nowait())
                except queue.Empty:
                    break                   # deadline flush
                if nxt is None:
                    self._q.put(nxt)        # stop token mid-collect: flush
                    break                   # this batch, then stop
                if total + nxt.n > self.max_batch:
                    carry = nxt             # first request of the NEXT batch
                    break                   # max_batch flush
                batch.append(nxt)
                total += nxt.n
            self._dispatch(batch, total)

    def _record_dispatch_locked(self, dt: float) -> None:
        self._dispatch_ema_s = (dt if self._dispatch_ema_s <= 0.0
                                else 0.2 * dt + 0.8 * self._dispatch_ema_s)

    def _dispatch(self, batch: List[_Request], total: int) -> None:
        images = (batch[0].images if len(batch) == 1
                  else np.concatenate([r.images for r in batch]))
        t0 = time.monotonic()
        try:
            out = self.engine.predict(images)
        except Exception as e:  # noqa: BLE001 — must reach the futures,
            now = time.monotonic()   # not kill the dispatcher thread
            with self._lock:
                self._pending -= total
                self._record_dispatch_locked(now - t0)
            if self.metrics is not None:
                self.metrics.observe_dispatch_error()
            for r in batch:
                _settle(r.future, exc=e)
            return
        now = time.monotonic()
        with self._lock:
            self._pending -= total
            self._record_dispatch_locked(now - t0)
        lo = 0
        for r in batch:
            _settle(r.future, tree_slice(out, lo, lo + r.n))
            lo += r.n
        if self.metrics is not None:
            self.metrics.observe_batch(
                n_real=total,
                bucket=pick_bucket(total, self.engine.buckets),
                dispatch_s=now - t0,
                request_latencies_s=[now - r.t_submit for r in batch],
                queue_waits_s=[t0 - r.t_submit for r in batch])

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Reject new work, finish everything already accepted, stop the
        dispatcher thread. Idempotent. True once it has exited."""
        with self._lock:
            self._draining = True
        self._q.put(None)
        self._thread.join(timeout)
        return not self._thread.is_alive()
