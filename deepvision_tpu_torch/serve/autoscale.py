"""Shed-driven autoscaling and per-model circuit breaking (port of
deepvision_tpu/serve/autoscale.py).

**AutoscaleController** — a sampling loop over the fleet's per-model
`ServingMetrics`. A dispatcher worker is a thread plus a reference to the
one engine (`DynamicBatcher.set_workers`): scaling up copies no weight and
builds nothing. The loop samples lifetime totals (deltas of shed and
admission refusals, which a concurrent metrics flush cannot zero) plus the
queue depth and the rolling p99 against the model's p99 bound
(`max_delay_ms + one max-bucket compute time`), and:

- scales UP one worker after `up_after` consecutive overloaded samples
  (shedding, or p99 past `p99_factor` x the bound with a standing queue);
- scales DOWN one worker after `down_after` consecutive idle samples (no
  shed, empty queue), deliberately slower than up: an idle thread costs
  nothing, a missing one sheds traffic;
- never leaves `[min_workers, max_workers]`, and waits `cooldown_s`
  between decisions so it measures the effect of the last one;
- at the ceiling, still shedding, ESCALATES: `escalations` counts it,
  `wants_scale_out` flags it on /healthz until the pressure is gone, and
  the `scale_out` hook, when given, is called (a tier supervisor adding a
  replica, serve/tier.py).

On one card the workers' forwards serialize on the device; a pool helps by
overlapping host work (the host-to-device copy, the answer's copy back,
the batch assembly) with another worker's forward.

Every decision is logged to the `resilience_` stream
(core/resilience.log_resilience_event), printed to stderr, and surfaced
per model on `/healthz`, `/stats` and `/metrics`.

**CircuitBreaker** — per-model fail-fast. K consecutive dispatch errors
open the circuit: `submit` answers `CircuitOpen` (HTTP 503 naming the
model) at once instead of queueing requests behind a broken dispatch
path. After `cooldown_s` the breaker goes half-open and admits ONE probe;
a successful dispatch closes it (any success does), a failed probe
re-opens it for another cooldown. Deterministically testable via
`DEEPVISION_FAULT_SERVE_DISPATCH_FAIL=<k>:<n>` (utils/faults.py).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, Iterable, Optional

from ..core.resilience import log_resilience_event

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-model dispatch circuit: closed -> (K consecutive errors) ->
    open -> (cooldown) -> half-open probe -> closed | re-open.

    `reject_for()` is the submit-path check: None admits the request,
    a float is the seconds until the next half-open probe (the 503's
    Retry-After). `record(ok)` is called by the dispatcher with every
    dispatch outcome. All transitions are logged (resilience_ stream +
    stderr) and counted for /healthz."""

    def __init__(self, name: str, *, k: int = 5, cooldown_s: float = 5.0,
                 logger=None):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        self.name = name
        self.k = int(k)
        self.cooldown_s = float(cooldown_s)
        self.logger = logger
        self._lock = threading.Lock()
        self.state = CLOSED
        self._consecutive = 0
        self._open_until = 0.0
        self._probe_started: Optional[float] = None
        self._events = 0
        self.opened = 0      # transition counters (monotonic, /healthz)
        self.reopened = 0
        self.closed_after_open = 0

    def reject_for(self) -> Optional[float]:
        """None = admit; else seconds until a probe will be admitted."""
        with self._lock:
            if self.state == CLOSED:
                return None
            now = time.monotonic()
            if self.state == OPEN:
                if now < self._open_until:
                    return self._open_until - now
                self.state = HALF_OPEN          # cooldown over: probe time
                self._probe_started = None
            # half-open: exactly one probe in flight. If an admitted probe
            # never produced a record() (refused later in submit, client
            # abandoned it), a fresh probe is allowed after one cooldown —
            # a lost probe must not wedge the breaker open forever.
            if (self._probe_started is not None
                    and now - self._probe_started < self.cooldown_s):
                return self._probe_started + self.cooldown_s - now
            self._probe_started = now
            return None

    def record(self, ok: bool, trace_ref: Optional[str] = None) -> None:
        """Dispatch outcome feed (called by DynamicBatcher._dispatch).
        `trace_ref` names the span of the dispatch that produced this
        outcome (``span:<id>``), so a breaker transition's resilience
        event joins back to the exact batch that tripped it."""
        transition = None
        with self._lock:
            if ok:
                self._consecutive = 0
                if self.state != CLOSED:
                    # ANY success closes — including a straggler batch that
                    # was admitted before the circuit opened: evidence the
                    # path works is evidence the path works
                    self.state = CLOSED
                    self._probe_started = None
                    self.closed_after_open += 1
                    transition = "closed"
            else:
                self._consecutive += 1
                if self.state == HALF_OPEN:
                    self.state = OPEN
                    self._open_until = time.monotonic() + self.cooldown_s
                    self._probe_started = None
                    self.reopened += 1
                    transition = "reopened"
                elif self.state == CLOSED and self._consecutive >= self.k:
                    self.state = OPEN
                    self._open_until = time.monotonic() + self.cooldown_s
                    self.opened += 1
                    transition = "opened"
            consecutive = self._consecutive
            if transition is not None:
                # event seq allocated under the lock: concurrent dispatcher
                # workers feed record() and a read-increment-read outside
                # the guard can collide or skip sequence numbers
                self._events += 1
                seq = self._events
        if transition is not None:
            log_resilience_event(self.logger, seq,
                                 {f"breaker_{transition}": 1.0,
                                  "breaker_consecutive_errors":
                                      float(consecutive)},
                                 trace_ref=trace_ref)
            print(f"[serve-breaker:{self.name}] circuit {transition}"
                  + (f" after {consecutive} consecutive dispatch errors "
                     f"(fail-fast 503 for {self.cooldown_s:g}s, then a "
                     f"half-open probe)" if transition != "closed"
                     else " (dispatch healthy again — traffic restored)"),
                  file=sys.stderr, flush=True)

    def describe(self) -> dict:
        with self._lock:
            return {"state": self.state, "k": self.k,
                    "cooldown_s": self.cooldown_s,
                    "consecutive_errors": self._consecutive,
                    "opened": self.opened, "reopened": self.reopened,
                    "closed_after_open": self.closed_after_open}


class AutoscaleController:
    """Background control loop over the fleet's served models (same
    lifecycle shape as reload.WeightReloader: `start()` spawns the daemon
    sampler, `check_once()` runs one sweep synchronously — the tests'
    handle — `stop()` joins)."""

    def __init__(self, models: Iterable, *,
                 interval_s: float = 1.0,
                 min_workers: int = 1,
                 max_workers: int = 4,
                 up_after: int = 2,
                 down_after: int = 10,
                 cooldown_s: float = 2.0,
                 p99_factor: float = 2.0,
                 scale_out=None,
                 logger=None):
        if max_workers < min_workers:
            raise ValueError(f"max_workers={max_workers} below "
                             f"min_workers={min_workers}")
        self.models = list(models)
        self.interval_s = float(interval_s)
        self.min_workers = max(1, int(min_workers))
        self.max_workers = int(max_workers)
        self.up_after = max(1, int(up_after))
        self.down_after = max(1, int(down_after))
        self.cooldown_s = float(cooldown_s)
        self.p99_factor = float(p99_factor)
        # the next lever once the worker ceiling is reached and the model
        # still sheds: called as scale_out(sm, refused=, queue_depth=), e.g.
        # by a supervisor that adds a tier replica (serve/tier.py); None
        # leaves the escalation a flag on /healthz
        self.scale_out = scale_out
        self.logger = logger
        self._state: Dict[str, dict] = {
            sm.name: {"last": sm.metrics.totals(), "up_streak": 0,
                      "idle_streak": 0, "last_change": 0.0}
            for sm in self.models}
        self._events = 0
        # serializes sampling sweeps: check_once() is public (tests and
        # operators call it) and races the daemon _loop thread on the
        # per-model streak/totals state otherwise
        self._sample_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "AutoscaleController":
        if self._thread is None and self.models and self.interval_s > 0:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="autoscaler")
            self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception as e:  # noqa: BLE001 — the sampler must
                # survive a transiently weird metrics read; next tick retries
                print(f"[serve-autoscale] sample failed (will retry): {e!r}",
                      file=sys.stderr, flush=True)

    # -- one sweep ---------------------------------------------------------

    def check_once(self) -> int:
        """Sample every model once; returns how many scaling decisions
        were taken this sweep."""
        decisions = 0
        with self._sample_lock:
            for sm in self.models:
                if self._check_model(sm):
                    decisions += 1
        return decisions

    def _p99_bound_ms(self, sm) -> Optional[float]:
        """The model's latency contract: max_delay + one max-bucket
        compute time. Measured once per model
        (5 warm dispatches) and cached on the ServedModel; engines without
        a measurement hook (test stubs) simply skip the p99 signal."""
        bound = getattr(sm, "p99_bound_ms", None)
        if bound is not None:
            return bound
        measure = getattr(sm.engine, "measure_batch_ms", None)
        if measure is None:
            return None
        bound = sm.batcher.max_delay * 1000.0 + measure()
        sm.p99_bound_ms = bound
        return bound

    def _check_model(self, sm) -> bool:
        st = self._state[sm.name]
        totals = sm.metrics.totals()
        last, st["last"] = st["last"], totals
        # overload evidence: requests refused for capacity reasons since
        # the last sample — backpressure shed AND admission refusals (both
        # mean "the queue could not absorb the offered rate"); breaker
        # rejections are a broken dispatch path, not missing capacity
        refused = ((totals["shed"] - last["shed"])
                   + (totals["admission_rejected"]
                      - last["admission_rejected"]))
        queue_depth = sm.batcher.queue_depth
        workers = sm.batcher.workers
        overload = refused > 0
        if not overload:
            bound = self._p99_bound_ms(sm)
            if bound:
                p99 = sm.metrics.snapshot().get("p99_ms", 0.0)
                overload = (p99 > self.p99_factor * bound
                            and queue_depth >= sm.batcher.max_batch)
        now = time.monotonic()
        if not overload and st.get("wants_scale_out"):
            # pressure receded without a scale-out: drop the escalation
            # flag so /healthz stops advertising a want that expired
            st["wants_scale_out"] = False
            with sm.reload_lock:
                sm.autoscale_stats["wants_scale_out"] = False
        if overload:
            st["up_streak"] += 1
            st["idle_streak"] = 0
            if (st["up_streak"] >= self.up_after
                    and now - st["last_change"] >= self.cooldown_s):
                if workers < self.max_workers:
                    st["up_streak"] = 0
                    st["last_change"] = now
                    sm.batcher.set_workers(workers + 1)
                    self._decide(sm, "scale_up", workers + 1,
                                 refused=refused, queue_depth=queue_depth)
                    return True
                # worker ceiling reached and still shedding: the next lever
                # is another replica, which this process cannot add
                st["up_streak"] = 0
                st["last_change"] = now
                self._escalate(sm, refused=refused, queue_depth=queue_depth)
                return True
        elif queue_depth == 0:
            st["idle_streak"] += 1
            st["up_streak"] = 0
            if (st["idle_streak"] >= self.down_after
                    and workers > self.min_workers
                    and now - st["last_change"] >= self.cooldown_s):
                st["idle_streak"] = 0
                st["last_change"] = now
                sm.batcher.set_workers(workers - 1)
                self._decide(sm, "scale_down", workers - 1,
                             refused=0, queue_depth=0)
                return True
        else:
            # neither shedding nor idle: a healthy standing queue — reset
            # both streaks so hysteresis measures CONSECUTIVE evidence
            st["up_streak"] = 0
            st["idle_streak"] = 0
        return False

    def _escalate(self, sm, *, refused: int, queue_depth: int) -> None:
        """The worker ceiling is reached and the model still sheds: record
        that the next lever is another replica (`escalations`, and
        `wants_scale_out` on /healthz until a sweep finds the pressure
        gone; the tier router aggregates it as `scale_out_wanted`), and
        call whoever owns that lever (`scale_out`). A worker is a thread
        over the one engine; a replica is a whole process with its own
        CUDA context, the dearer last resort."""
        self._state[sm.name]["wants_scale_out"] = True
        with sm.reload_lock:
            stats = sm.autoscale_stats
            stats["escalations"] = stats.get("escalations", 0) + 1
            stats["wants_scale_out"] = True
            stats["last_decision"] = "escalate"
            stats["last_decision_unix"] = time.time()
        self._events += 1
        log_resilience_event(self.logger, self._events,
                             {"autoscale_escalate": 1.0,
                              "autoscale_workers":
                                  float(sm.batcher.workers),
                              "autoscale_refused_delta": float(refused),
                              "autoscale_queue_depth": float(queue_depth)})
        print(f"[serve-autoscale:{sm.name}] escalate: worker ceiling "
              f"{self.max_workers} reached and still shedding ({refused} "
              f"requests refused since last sample, queue depth "
              f"{queue_depth}) — the next lever is another replica "
              f"(serve/tier.py); wants_scale_out flagged on /healthz",
              file=sys.stderr, flush=True)
        if self.scale_out is not None:
            try:
                self.scale_out(sm, refused=refused,
                               queue_depth=queue_depth)
            except Exception as e:  # noqa: BLE001 — the hook is advisory:
                # a broken lever must not kill the sampler
                print(f"[serve-autoscale:{sm.name}] scale_out hook "
                      f"failed: {e!r}", file=sys.stderr, flush=True)

    def _decide(self, sm, decision: str, workers: int, *,
                refused: int, queue_depth: int) -> None:
        with sm.reload_lock:
            stats = sm.autoscale_stats
            stats[f"{decision}s"] = stats.get(f"{decision}s", 0) + 1
            stats["workers"] = workers
            stats["last_decision"] = decision
            stats["last_decision_unix"] = time.time()
        self._events += 1
        log_resilience_event(self.logger, self._events,
                             {f"autoscale_{decision}": 1.0,
                              "autoscale_workers": float(workers),
                              "autoscale_refused_delta": float(refused),
                              "autoscale_queue_depth": float(queue_depth)})
        print(f"[serve-autoscale:{sm.name}] {decision} -> {workers} "
              f"worker(s) ({refused} requests refused since last sample, "
              f"queue depth {queue_depth}; bounds "
              f"[{self.min_workers},{self.max_workers}])",
              file=sys.stderr, flush=True)
