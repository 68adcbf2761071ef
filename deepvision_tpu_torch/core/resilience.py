"""Resilience primitives of the trainers and the serve path (own copy of
deepvision_tpu/core/resilience.py), and `stop_agreed`, the preemption stop
that every rank of a data-parallel run takes at the same step:

- `RetryPolicy` / `call_with_retry`: bounded exponential backoff with
  jitter around transient host I/O (checkpoint save and restore, the data
  pull): `OSError` is retried, everything else propagates untouched.
- `resilient_batches`: a host batch iterator under the retry policy and
  the fault injector (utils/faults.py), so flaky storage mid-epoch costs a
  logged retry, not the run.
- `GracefulShutdown` + `PreemptionExit`: SIGTERM/SIGINT set a flag the
  step loop polls; the trainer finishes the step in flight, commits a
  checkpoint and exits 0 with the resume hint.
- `StepWatchdog`: an in-process stall detector that aborts with
  diagnostics (exit code 70) when no step completes for a threshold.
- `log_resilience_event`: the `resilience_` metrics stream.

Divergence recovery itself (rollback, LR scale-down, bounded retry) lives
in the trainers' fit loops (core/trainer.py, core/gan.py), gated by
`TrainConfig.recover_on_divergence`.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import sys
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

from ..parallel import mesh


@dataclasses.dataclass
class RetryPolicy:
    """Bounded exponential backoff: attempt n sleeps
    min(max_delay, base_delay * 2^(n-1)) * (1 + U[0, jitter]), U drawn
    from `random.Random(seed)`, so a schedule is reproducible."""

    max_retries: int = 3
    base_delay: float = 0.5
    max_delay: float = 8.0
    jitter: float = 0.25
    seed: int = 0

    @classmethod
    def from_env(cls, env=None, **overrides) -> "RetryPolicy":
        """DEEPVISION_IO_RETRIES / DEEPVISION_IO_RETRY_DELAY override the
        defaults."""
        env = os.environ if env is None else env
        kw = dict(overrides)
        if "DEEPVISION_IO_RETRIES" in env:
            kw["max_retries"] = int(env["DEEPVISION_IO_RETRIES"])
        if "DEEPVISION_IO_RETRY_DELAY" in env:
            kw["base_delay"] = float(env["DEEPVISION_IO_RETRY_DELAY"])
        return cls(**kw)

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
        return d * (1.0 + rng.random() * self.jitter)


def call_with_retry(fn: Callable, policy: RetryPolicy, *, what: str,
                    on_retry: Optional[Callable] = None):
    """Run `fn()`, retrying a transient `OSError` up to
    `policy.max_retries` times with backoff. `on_retry(what, attempt, exc,
    delay)` fires before each sleep (the trainers log it). The last
    failure re-raises unchanged."""
    rng = random.Random(policy.seed)
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as e:
            attempt += 1
            if attempt > policy.max_retries:
                raise
            d = policy.delay(attempt, rng)
            if on_retry is not None:
                on_retry(what, attempt, e, d)
            time.sleep(d)


def resilient_batches(batches: Iterable, policy: RetryPolicy,
                      injector=None,
                      on_retry: Optional[Callable] = None) -> Iterator:
    """Yield from a host batch iterator, retrying a transient OSError from
    the pull itself and applying the fault injector's data hooks. The
    injected fault fires before the pull, so no batch is lost on retry."""
    it = iter(batches)

    def pull():
        if injector is not None:
            injector.before_batch()
        return next(it)

    while True:
        try:
            batch = call_with_retry(pull, policy, what="data_io",
                                    on_retry=on_retry)
        except StopIteration:
            return
        if injector is not None:
            batch = injector.poison_batch(batch)
        yield batch


def log_resilience_event(logger, step: int, metrics: dict,
                         epoch: Optional[int] = None, *,
                         request_id: Optional[str] = None,
                         trace_ref: Optional[str] = None,
                         flywheel_id: Optional[str] = None) -> None:
    """Write one event onto the `resilience_` metrics stream — the single
    forensics channel every recovery path shares (divergence rollbacks,
    refused reloads, promotion verdicts, breaker transitions and sheds in
    the serving stack): prefixed keys, float values, no console echo, same
    JSONL stream as the run's ordinary metrics so incidents line up with
    the serving and training timelines. A None logger is a no-op, so
    callers without a metrics stream need no guard. `request_id` (the HTTP
    request that triggered the event) and `trace_ref` (``span:<id>`` of
    the span that produced it, `GET /trace`) are written as string fields,
    so an event joins the spans and the client log line behind it.
    `flywheel_id` is the third such field: the episode id the flywheel
    controller (flywheel/controller.py) mints at a drift event and carries
    through every decision of that drift -> retrain -> promote episode."""
    if logger is None:
        return
    extra = {}
    if request_id is not None:
        extra["request_id"] = str(request_id)
    if trace_ref is not None:
        extra["trace_ref"] = str(trace_ref)
    if flywheel_id is not None:
        extra["flywheel_id"] = str(flywheel_id)
    logger.log(step, {k: float(v) for k, v in metrics.items()},
               prefix="resilience_", echo=False, extra=extra or None,
               epoch=epoch)


class PreemptionExit(Exception):
    """Raised by fit() after a graceful-shutdown checkpoint is committed;
    `fit_and_close` (and the GAN mains) turn it into the resume hint and
    exit 0. Carries the committed epoch."""

    def __init__(self, epoch: int, message: str):
        super().__init__(message)
        self.epoch = epoch


class GracefulShutdown:
    """SIGTERM/SIGINT → a polled flag, installed for the duration of a
    serving lifetime (serve/server.py), a smoke run (serve/cli.py) or a
    training run (core/trainer.py).

    A SECOND signal restores the previous handlers and re-raises, so a
    stuck shutdown stays killable with plain Ctrl-C Ctrl-C. Signal handlers
    only exist on the main thread; elsewhere this degrades to an inert flag
    that is never set.

    `on_signal` (optional) fires once, after the flag is set, so loops that
    WAIT rather than poll can be woken immediately — pass something
    async-signal-safe like `Event.set`. `what` customizes the one-line
    announcement."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, on_signal: Optional[Callable[[], None]] = None,
                 what: str = "finishing in-flight work, then exiting 0"):
        self.requested = False
        self._previous = {}
        self._on_signal = on_signal
        self._what = what

    def _handler(self, signum, frame):
        if self.requested:  # second signal: get out of the way
            self._restore()
            raise KeyboardInterrupt
        self.requested = True
        print(f"[resilience] caught {signal.Signals(signum).name}: "
              f"{self._what} (signal again to abort immediately)",
              file=sys.stderr, flush=True)
        if self._on_signal is not None:
            try:
                self._on_signal()
            except Exception:  # noqa: BLE001 — a handler must never throw
                pass

    def __enter__(self) -> "GracefulShutdown":
        try:
            for s in self.SIGNALS:
                self._previous[s] = signal.signal(s, self._handler)
        except ValueError:  # not the main thread: flag stays inert
            self._previous = {}
        return self

    def _restore(self):
        for s, h in self._previous.items():
            signal.signal(s, h)
        self._previous = {}

    def __exit__(self, *exc):
        self._restore()
        return False


class StepWatchdog:
    """Host-side stall detector: a daemon thread that aborts the process
    when no `beat()` lands within `threshold_secs` (monotonic clock).

    Before aborting it prints the diagnostics (last step, last committed
    checkpoint epoch, prefetch queue depth) and every thread's stack
    (faulthandler), then `os._exit(EXIT_CODE)`, so a wrapping retry loop
    can relaunch with --auto-resume. The trainers beat when a step's
    completion reaches the host (on the card: its event has completed),
    not when it was enqueued. Off unless a threshold is configured
    (`--watchdog-secs` / DEEPVISION_WATCHDOG_SECS). `_abort` replaces the
    exit, for tests."""

    EXIT_CODE = 70  # EX_SOFTWARE: distinguishable from the step's own errors

    def __init__(self, threshold_secs: float,
                 diagnostics: Optional[Callable[[], dict]] = None,
                 name: str = "trainer",
                 _abort: Optional[Callable] = None):
        if threshold_secs <= 0:
            raise ValueError(f"watchdog threshold must be > 0, "
                             f"got {threshold_secs}")
        self.threshold = threshold_secs
        self.diagnostics = diagnostics
        self.name = name
        self._abort = _abort if _abort is not None else self._default_abort
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._watch, daemon=True, name=f"step-watchdog-{name}")
        self._thread.start()

    def beat(self) -> None:
        self._last = time.monotonic()

    def _watch(self) -> None:
        poll = min(1.0, self.threshold / 4.0)
        while not self._stop.wait(poll):
            stalled = time.monotonic() - self._last
            if stalled >= self.threshold:
                self._dump(stalled)
                self._abort()
                return

    def _dump(self, stalled: float) -> None:
        info = {}
        if self.diagnostics is not None:
            try:
                info = self.diagnostics()
            except Exception as e:  # noqa: BLE001 — diagnostics must not
                info = {"diagnostics_error": repr(e)}  # mask the stall
        detail = " ".join(f"{k}={v}" for k, v in info.items())
        print(f"[watchdog:{self.name}] no step progress for {stalled:.0f}s "
              f"(threshold {self.threshold:.0f}s) — aborting. {detail}",
              file=sys.stderr, flush=True)
        try:
            import faulthandler
            faulthandler.dump_traceback(file=sys.stderr)
        except Exception:  # noqa: BLE001 — the abort still proceeds
            pass

    @classmethod
    def _default_abort(cls) -> None:
        # os._exit, not sys.exit: the main thread is wedged and would never
        # unwind an exception
        os._exit(cls.EXIT_CODE)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "StepWatchdog":
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def stop_agreed(shutdown: Optional[GracefulShutdown]) -> bool:
    """Whether `shutdown` was requested here or on any other rank: a
    signal reaches one rank, and every rank must leave the step loop at
    the same step, or one would wait forever in a collective the others
    never enter. Without a process group, the local flag."""
    return mesh.agree_any(shutdown is not None and shutdown.requested)
