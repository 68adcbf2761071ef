"""Dynamic micro-batching: coalesce concurrent requests into one dispatch
(port of deepvision_tpu/serve/batcher.py).

Concurrent `submit()` calls land in a thread-safe queue; a POOL of
dispatcher workers (1 by default) coalesces them up to `max_batch`
examples or until the OLDEST request's `max_delay_ms` deadline expires —
whichever comes first — runs one engine dispatch (padded to the nearest
bucket), and scatters the per-request output slices back through
`concurrent.futures.Future`s. Every request lives in exactly one batch, so
row ownership does not depend on the worker count; the workers share the
one engine, so `set_workers()` is a thread and a reference, no weight
copied (the autoscaler's lever, serve/autoscale.py). All workers run on
the card's current stream: their forwards serialize on the device, and
what a second worker overlaps is host work (batch assembly, the
host-to-device copy, the answer's copy back).

A batch runs ONE weight generation and ONE precision: requests tagged
for the promotion canary's candidate (`generation="candidate"`) never
share a batch with live ones, nor requests pinned to "int8" with those
pinned to "bf16" or to the model's active precision (the collect loop
flushes at either boundary).

Overload control at the door (`submit` refuses BEFORE accepting — nothing
partial ever happens):

- `Overloaded` (HTTP 429): once `max_queue_examples` are pending, shed
  instead of building an unbounded latency queue.
- `DeadlineUnmeetable` (HTTP 503 + Retry-After): when the dispatch-time EMA
  x queued batches / workers says the answer cannot arrive in time,
  refuse NOW.
- `CircuitOpen` (HTTP 503 naming the model): the model's circuit breaker
  (serve/autoscale.CircuitBreaker) is open after K consecutive dispatch
  errors — fail fast until the half-open probe proves the path again.
- `Draining` (HTTP 503): shutting down; in-flight batches finish.

`result_within()` is the deadline-bounded wait every caller of a submit
future uses: a wedged dispatch answers `DeadlineExpired` (HTTP 504) in
bounded time.

When a tracer is attached (`tracer`, the server's), every dispatch records
a `batch` span (bucket, generation, worker, the sampled requests it
served) with a `device_dispatch` child, and each sampled request its
`queue_wait` span linked to that batch. `observer`, when set, is called
after every dispatch with the batch's generation, latencies, dispatch time
and error (the promotion canary's feed); an observer that raises is
counted on the metrics and logged once per distinct error.
"""

from __future__ import annotations

import math
import queue
import sys
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import List, Optional

import numpy as np

from ..core.resilience import log_resilience_event
from ..utils.faults import FaultInjector
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


class CircuitOpen(RequestRejected):
    """The model's circuit breaker is open (K consecutive dispatch errors):
    fail fast with the model's name (HTTP 503 + Retry-After) until the
    half-open probe closes it."""

    def __init__(self, msg: str, *, model: str, retry_after_s: float):
        super().__init__(msg)
        self.model = model
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
    __slots__ = ("images", "n", "future", "t_submit", "generation",
                 "precision", "trace")

    def __init__(self, images: np.ndarray, generation: Optional[str] = None,
                 precision: Optional[str] = None, trace=None):
        self.images = images
        self.n = images.shape[0]
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        # weight generation this request is pinned to (None = live)
        self.generation = generation
        # precision it is pinned to (None = the model's active one at
        # dispatch time)
        self.precision = precision
        # obs.trace.TraceContext of a SAMPLED request (None otherwise)
        self.trace = trace


# queue control tokens: None stops ALL workers (drain; each exiting worker
# puts it back for its siblings); _RETIRE stops exactly one SUPERNUMERARY
# worker (scale-down: a worker that pops it while the pool is already at
# its target drops it, so a stale token never shrinks below the target)
_RETIRE = object()


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
    """Thread-safe request queue + a pool of dispatcher workers over an
    engine.

    `submit(images) -> Future` accepts `(n, *example_shape)` with
    `1 <= n <= max_batch` (or one bare example); the future resolves to the
    output rows of exactly those n examples, in order, and carries
    `generation` ("live" / "candidate") and `weights` (that generation's
    provenance): the weights that computed them. `workers` sizes the
    initial pool; `set_workers()` resizes it live. `default_deadline_s`
    arms admission control for submits that don't carry their own deadline
    (None = every request admitted regardless of the queue).
    """

    def __init__(self, engine: PredictEngine, *,
                 max_batch: Optional[int] = None,
                 max_delay_ms: float = 5.0,
                 max_queue_examples: int = 1024,
                 metrics=None,
                 workers: int = 1,
                 default_deadline_s: Optional[float] = None,
                 faults: Optional[FaultInjector] = None):
        if max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0, got {max_delay_ms}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.engine = engine
        self.max_batch = min(int(max_batch or engine.max_batch),
                             engine.max_batch)
        self.max_delay = max_delay_ms / 1000.0
        self.max_queue_examples = int(max_queue_examples)
        self.metrics = metrics
        self.default_deadline_s = default_deadline_s
        # the model's circuit breaker (attached by fleet.add); None = none
        self.breaker = None
        # resilience_ stream for observer errors (set by the server)
        self.logger = None
        # obs.trace.Tracer (set by the server); None = tracing off
        self.tracer = None
        self.faults = faults if faults is not None else FaultInjector.from_env()
        # per-batch tap `observer(generation, latencies_s, dispatch_s,
        # error, sample=None)`: the promotion canary's feed. Called from a
        # worker after every future of the batch is settled; `sample` holds
        # references to the batch's input and outputs and its trace ref.
        self.observer = None
        self._observer_errors_seen: set = set()
        self._observer_error_seq = 0
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._pending = 0          # examples accepted, results not yet set
        self._draining = False
        # EMA of per-batch dispatch wall time — the admission controller's
        # service-time estimate (0 until the first dispatch: no evidence,
        # every deadline admitted)
        self._dispatch_ema_s = 0.0
        self._threads: List[threading.Thread] = []
        self._target_workers = int(workers)
        self._worker_seq = 0
        with self._lock:
            for _ in range(self._target_workers):
                self._spawn_locked()

    @property
    def queue_depth(self) -> int:
        """Examples accepted whose results are not yet delivered."""
        with self._lock:
            return self._pending

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    # -- worker pool -------------------------------------------------------

    @property
    def workers(self) -> int:
        with self._lock:
            return len(self._threads)

    def _spawn_locked(self) -> None:
        self._worker_seq += 1
        t = threading.Thread(
            target=self._loop, daemon=True,
            name=f"dispatch-worker-{self.engine.name}-{self._worker_seq}")
        self._threads.append(t)
        t.start()

    def set_workers(self, n: int) -> int:
        """Resize the dispatcher pool to n workers (>= 1). Growing spawns
        threads at once; shrinking enqueues retire tokens that each stop
        one worker at a batch boundary — no in-flight batch is abandoned.
        Returns the new target. A draining batcher does not resize."""
        n = max(1, int(n))
        with self._lock:
            if self._draining:
                return len(self._threads)
            self._target_workers = n
            while len(self._threads) < n:
                self._spawn_locked()
            retire = len(self._threads) - n
        for _ in range(retire):
            self._q.put(_RETIRE)
        return n

    # -- client side -------------------------------------------------------

    def submit(self, images, *, generation: Optional[str] = None,
               precision: Optional[str] = None,
               deadline_s: Optional[float] = None, trace=None) -> Future:
        x = self.engine._coerce(images)
        n = x.shape[0]
        if n > self.max_batch:
            raise ValueError(
                f"request of {n} examples exceeds max_batch="
                f"{self.max_batch}; split client batches")
        if precision is not None:
            # an unknown or unarmed precision is refused at the door (400),
            # not in a batch of doomed futures
            self.engine._resolve_precision(precision)
        breaker = self.breaker
        if breaker is not None:
            wait_s = breaker.reject_for()
            if wait_s is not None:
                if self.metrics is not None:
                    self.metrics.observe_breaker_reject()
                raise CircuitOpen(
                    f"circuit open for model {breaker.name!r} after "
                    f"{breaker.k} consecutive dispatch errors — failing "
                    f"fast; half-open probe in {wait_s:.2f}s",
                    model=breaker.name, retry_after_s=wait_s)
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
                        f"{self._dispatch_ema_s * 1000:.1f}ms x "
                        f"{len(self._threads)} worker(s)) — refused at the "
                        f"door so you can retry elsewhere",
                        eta_s=eta, deadline_s=dl, retry_after_s=retry)
            self._pending += n
            # enqueued under the lock: drain() flips `_draining` under it
            # before its stop token, so no accepted request can land behind
            # the token and go unanswered
            req = _Request(x, generation=generation, precision=precision,
                           trace=trace)
            self._q.put(req)
        return req.future

    def _eta_locked(self, n: int) -> float:
        """Expected submit->result time for an n-example request arriving
        NOW: the coalescing wait plus (batches ahead of and including it)
        x dispatch EMA, divided across the worker pool. Optimistic when
        there is no dispatch evidence yet (EMA 0 admits everything)."""
        ema = self._dispatch_ema_s
        if ema <= 0.0:
            return 0.0
        batches_ahead = math.ceil((self._pending + n) / self.max_batch)
        workers = max(1, len(self._threads))
        return self.max_delay + ema * (batches_ahead / workers)

    # -- dispatcher workers ------------------------------------------------

    def _loop(self) -> None:
        carry: Optional[_Request] = None   # overflow of this worker's last
        while True:                        # batch (per worker, not shared)
            first = carry
            carry = None
            if first is None:
                first = self._q.get()       # idle: block until work or stop
            if first is None:               # stop: everything accepted
                self._q.put(None)           # before it has been dispatched;
                break                       # put back for the siblings
            if first is _RETIRE:            # scale-down token: stop exactly
                with self._lock:            # one supernumerary worker
                    if len(self._threads) > self._target_workers:
                        self._threads.remove(threading.current_thread())
                        return
                continue                    # stale token (target re-raised)
            t_collect = time.monotonic()    # the batch span's left edge
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
                if nxt is None or nxt is _RETIRE:
                    self._q.put(nxt)        # control token mid-collect:
                    break                   # hand it back, flush this batch
                if total + nxt.n > self.max_batch \
                        or nxt.generation != first.generation \
                        or nxt.precision != first.precision:
                    carry = nxt             # first request of the NEXT batch:
                    break                   # full, or a generation or
                                            # precision boundary
                batch.append(nxt)
                total += nxt.n
            self._dispatch(batch, total, t_collect)

    def _record_dispatch_locked(self, dt: float) -> None:
        self._dispatch_ema_s = (dt if self._dispatch_ema_s <= 0.0
                                else 0.2 * dt + 0.8 * self._dispatch_ema_s)

    def _dispatch(self, batch: List[_Request], total: int,
                  t_collect: Optional[float] = None) -> None:
        images = (batch[0].images if len(batch) == 1
                  else np.concatenate([r.images for r in batch]))
        generation = batch[0].generation   # the whole batch shares both
        precision = batch[0].precision
        # the label metrics and spans carry: the request's precision, else
        # the model's active one as the dispatch starts
        label = precision or self.engine.precision
        t0 = time.monotonic()
        try:
            self.faults.before_serve_dispatch()
            # None runs the engine's active rung
            out, served, weights = self.engine.dispatch(
                images, generation, precision=precision)
        except Exception as e:  # noqa: BLE001 — must reach the futures,
            now = time.monotonic()   # not kill the dispatcher worker
            with self._lock:
                self._pending -= total
                self._record_dispatch_locked(now - t0)
            if self.metrics is not None:
                self.metrics.observe_dispatch_error()
            trace_ref = self._trace_batch(batch, total, t_collect, t0, now,
                                          generation, label, error=repr(e))
            if self.breaker is not None:
                # the failing batch's span is the breaker's evidence: a
                # breaker_opened event joins back to it
                self.breaker.record(ok=False, trace_ref=trace_ref)
            for r in batch:
                _settle(r.future, exc=e)
            self._observe(generation, [now - r.t_submit for r in batch],
                          now - t0, e, trace_ref=trace_ref, images=images)
            return
        now = time.monotonic()
        with self._lock:
            self._pending -= total
            self._record_dispatch_locked(now - t0)
        if self.breaker is not None:
            self.breaker.record(ok=True)
        lo = 0
        for r in batch:
            # the generation that computed these rows and its provenance,
            # read with the weights themselves: exact across a concurrent
            # swap, promotion or rollback (set before the result wakes
            # the waiter)
            r.future.generation, r.future.weights = served, weights
            _settle(r.future, tree_slice(out, lo, lo + r.n))
            lo += r.n
        latencies = [now - r.t_submit for r in batch]
        if self.metrics is not None:
            self.metrics.observe_batch(
                n_real=total,
                bucket=pick_bucket(total, self.engine.buckets),
                dispatch_s=now - t0,
                request_latencies_s=latencies,
                queue_waits_s=[t0 - r.t_submit for r in batch],
                precision=label)
        trace_ref = self._trace_batch(batch, total, t_collect, t0, now,
                                      generation, label)
        self._observe(generation, latencies, now - t0, None,
                      trace_ref=trace_ref, images=images, outputs=out)

    def _trace_batch(self, batch: List[_Request], total: int,
                     t_collect: Optional[float], t0: float, now: float,
                     generation: Optional[str], precision: str = "bf16",
                     error: Optional[str] = None) -> Optional[str]:
        """Record the batch-level spans (one `batch` span naming its
        sampled requests, plus the `device_dispatch` child) and each
        sampled member's `queue_wait` span. Returns a ``span:<id>`` trace
        ref for the resilience events this dispatch may trigger, or None
        when tracing is off — the whole method is behind ONE branch."""
        tr = self.tracer
        if tr is None or not tr.enabled:
            return None
        name = self.engine.name
        worker = threading.current_thread().name
        bid = tr.new_id()
        traced = [r for r in batch if r.trace is not None]
        for r in traced:
            tr.add("queue_wait", "serve", int(r.t_submit * 1e9),
                   int((t0 - r.t_submit) * 1e9),
                   args={"request_id": r.trace.request_id, "batch": bid,
                         "model": name}, tid=worker)
        args = {"model": name,
                "bucket": pick_bucket(total, self.engine.buckets),
                "generation": generation or "live", "worker": worker,
                "precision": precision,
                "n_real": total, "n_requests": len(batch),
                "requests": [r.trace.request_id for r in traced]}
        if error is not None:
            args["error"] = error
        t_batch = t_collect if t_collect is not None else batch[0].t_submit
        tr.add("batch", "serve", int(t_batch * 1e9),
               int((now - t_batch) * 1e9), args=args, span_id=bid,
               tid=worker)
        tr.add("device_dispatch", "serve", int(t0 * 1e9),
               int((now - t0) * 1e9),
               args={"model": name, "batch": bid,
                     "generation": generation or "live"}, tid=worker)
        return f"span:{bid}"

    def _observe(self, generation, latencies, dispatch_s, error,
                 trace_ref: Optional[str] = None,
                 images=None, outputs=None) -> None:
        observer = self.observer
        if observer is None:
            return
        # references only, assembled AFTER every future is settled: a slow
        # or broken tap can never delay or damage a client's result
        sample = {"images": images, "outputs": outputs,
                  "trace_ref": trace_ref}
        try:
            observer(generation or "live", latencies, dispatch_s, error,
                     sample=sample)
        except Exception as e:  # noqa: BLE001 — a broken tap must not take
            # the worker (and every future) with it, nor go unnoticed:
            # count it, and log one resilience event per distinct error
            if self.metrics is not None:
                self.metrics.observe_observer_error()
            key = (type(e).__name__, str(e))
            with self._lock:
                fresh = key not in self._observer_errors_seen
                if fresh:
                    self._observer_errors_seen.add(key)
                    self._observer_error_seq += 1
                    seq = self._observer_error_seq
            if fresh:
                log_resilience_event(self.logger, seq,
                                     {"serve_observer_error": 1.0},
                                     trace_ref=trace_ref)
                print(f"[serve:{self.engine.name}] batch observer raised "
                      f"{type(e).__name__}: {e} (suppressed; counted on "
                      f"metrics, further repeats silent)",
                      file=sys.stderr, flush=True)

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Reject new work, finish everything already accepted, stop every
        dispatcher worker. Idempotent. True once all workers have exited."""
        with self._lock:
            self._draining = True
            threads = list(self._threads)
        self._q.put(None)
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = True
        for t in threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
            ok = ok and not t.is_alive()
        return ok
