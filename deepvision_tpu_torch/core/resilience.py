"""Resilience primitives the serve path uses (own copy of
deepvision_tpu/core/resilience.py: `log_resilience_event` and
`GracefulShutdown`). Retry policies, the step watchdog and divergence
recovery arrive with the training slice.
"""

from __future__ import annotations

import signal
import sys
from typing import Callable, Optional


def log_resilience_event(logger, step: int, metrics: dict, *,
                         request_id: Optional[str] = None) -> None:
    """Write one event onto the `resilience_` metrics stream — the single
    forensics channel every recovery path shares (sheds and refusals in the
    serving stack): prefixed keys, float values, no console echo, same
    JSONL stream as the run's ordinary metrics so incidents line up with
    the serving timeline. A None logger is a no-op, so callers without a
    metrics stream need no guard. `request_id` is written as a string
    field so an event joins the client log line behind it."""
    if logger is None:
        return
    extra = {"request_id": str(request_id)} if request_id is not None else None
    logger.log(step, {k: float(v) for k, v in metrics.items()},
               prefix="resilience_", echo=False, extra=extra)


class GracefulShutdown:
    """SIGTERM/SIGINT → a polled flag, installed for the duration of a
    serving lifetime (serve/server.py) or a smoke run (serve/cli.py).

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
