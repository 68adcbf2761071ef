"""Drift detection for one served model: pinned reference vs live traffic
(port of deepvision_tpu/flywheel/drift.py).

The monitor owns the *detect* half of the flywheel loop. It compares two
streams that share every primitive with the existing gates, so the
comparison can never disagree with them on recipe:

- **Reference**: the pinned calibration shard (`core/scoring.pinned_shard`)
  — the byte-deterministic batch the promotion gate already replays. Its
  per-channel input moments (`core/scoring.input_moments`) are the
  reference distribution, and the family's watched metric scored on it at
  the first evaluation is the reference quality baseline.
- **Live**: a bounded reservoir of inputs sampled at the batcher's
  per-batch observer tap (`DynamicBatcher` passes `sample=` references;
  the monitor COPIES the few rows it keeps, so retained samples never pin
  whole request batches). Once a full window accumulates, `tick()` reduces
  it with the same `input_moments` and scores the live generation on the
  pinned shard again (on the card, through the engine's buckets) — watch
  decay is baseline minus current.

A window *breaches* when the input moment shift exceeds `input_gate`
(reference-σ units, `core/scoring.moment_shift`) or the watch decay
exceeds `watch_gate`. Detection needs `hysteresis_windows` CONSECUTIVE
breaches: a transient spike (one hot batch, a brief upstream glitch)
resets the streak and never triggers. On trigger the monitor mints the
episode's `flywheel_id` — the correlation key every downstream decision
of that drift→retrain→promote episode carries (core/resilience.py).

The observer tap is CHAINED, not stolen: the promotion controller owns
`batcher.observer` for its canary comparison, so the monitor saves the
previous observer and calls it first from its own. Ingest (dispatcher
worker threads) only appends copies under a lock; all evaluation happens
in `tick()` on the flywheel controller's thread — detection work never
rides the dispatch path, so watching for drift sheds no healthy traffic.

`DEEPVISION_FAULT_DRIFT_SHIFT=<window>:<magnitude>` (utils/faults.py)
rehearses the whole loop deterministically: from the armed window on,
ingested samples get a constant additive shift, which moves the window
moments without touching real traffic.
"""

from __future__ import annotations

import threading
import uuid
from typing import List, Optional

import numpy as np

from ..core import scoring
from ..core.resilience import log_resilience_event
from ..utils.faults import FaultInjector


class DriftMonitor:
    """Streaming drift detector for one `ServedModel`. Construct it AFTER
    the promotion controller (observer chaining preserves whatever tap was
    installed first); `tick()` is driven by the flywheel controller's
    thread or by tests — never by request threads."""

    def __init__(self, sm, cfg=None, *,
                 window_examples: int = 32,
                 sample_per_batch: int = 4,
                 input_gate: float = 0.5,
                 watch_gate: float = 0.1,
                 hysteresis_windows: int = 3,
                 eval_examples: int = 64,
                 seed: int = scoring.DEFAULT_SHARD_SEED,
                 logger=None,
                 faults: Optional[FaultInjector] = None):
        if window_examples <= 0:
            raise ValueError(f"window_examples must be > 0, got "
                             f"{window_examples}")
        if sample_per_batch <= 0:
            raise ValueError(f"sample_per_batch must be > 0, got "
                             f"{sample_per_batch}")
        if hysteresis_windows < 1:
            raise ValueError(f"hysteresis_windows must be >= 1, got "
                             f"{hysteresis_windows} — 1 means every "
                             f"breaching window triggers")
        from ..configs import get_config
        self.sm = sm
        self.cfg = cfg if cfg is not None else get_config(sm.name)
        if self.cfg.family not in scoring.GATED_FAMILIES:
            raise ValueError(
                f"config {sm.name!r} (family {self.cfg.family!r}) has no "
                f"predict-side watch metric — the flywheel monitors "
                f"families {scoring.GATED_FAMILIES}")
        self.window_examples = int(window_examples)
        self.sample_per_batch = int(sample_per_batch)
        self.input_gate = float(input_gate)
        self.watch_gate = float(watch_gate)
        self.hysteresis_windows = int(hysteresis_windows)
        self.watch_name = scoring.watch_metric_name(self.cfg)
        self.logger = logger
        self.faults = faults if faults is not None else FaultInjector.from_env()

        # the pinned reference: the promotion gate's shard recipe,
        # byte-deterministic per (config, seed)
        self._ref_images, self._ref_targets = scoring.pinned_shard(
            self.cfg, image_size=sm.engine.example_shape[0],
            input_dtype=sm.engine.input_dtype,
            examples=int(eval_examples), seed=int(seed))
        self.ref_mean, self.ref_std = scoring.input_moments(self._ref_images)
        # watch baseline is captured lazily at first evaluation so building
        # a monitor costs no predict; from then on it only moves on
        # rebaseline()
        self.baseline_watch: Optional[float] = None

        self._lock = threading.Lock()
        self._rows: List[np.ndarray] = []   # copied sample rows, <= window
        self._last_trace_ref: Optional[str] = None
        self._last_moments = None           # (mean, std) of the last window
        self.windows = 0                    # full windows evaluated
        self.breaches = 0                   # windows over either gate
        self.consecutive = 0                # current breach streak
        self.triggered_id: Optional[str] = None
        self.last_input_shift = 0.0
        self.last_watch_decay = 0.0
        self._events = 0

        # chain the batcher tap: the promotion controller (or any earlier
        # observer) keeps seeing every batch through us
        self._prev_observer = sm.batcher.observer
        sm.batcher.observer = self._observe

    # -- ingest (dispatcher worker threads: copy + append, nothing else) ---

    def _observe(self, generation: str, latencies_s, dispatch_s, error,
                 sample=None) -> None:
        if self._prev_observer is not None:
            self._prev_observer(generation, latencies_s, dispatch_s, error,
                                sample=sample)
        if error is not None or sample is None or generation != "live":
            return                      # canary traffic would skew moments
        images = sample.get("images")
        if images is None or len(images) == 0:
            return
        rows = np.asarray(images[:self.sample_per_batch], np.float32).copy()
        if rows.ndim != 4:
            return                      # not an image batch we can moment
        with self._lock:
            shift = self.faults.drift_shift(self.windows)
            if shift:
                rows = rows + np.float32(shift)
            room = self.window_examples - len(self._rows)
            if room <= 0:
                return                  # window full: wait for a tick
            self._rows.extend(rows[:room])
            if sample.get("trace_ref"):
                self._last_trace_ref = sample["trace_ref"]

    # -- evaluation (controller thread / tests) ----------------------------

    def _ensure_baseline(self) -> float:
        if self.baseline_watch is None:
            self.baseline_watch = self._score_live()
        return self.baseline_watch

    def _score_live(self) -> float:
        """The live generation's watched metric on the pinned shard — the
        exact replay the promotion gate's shadow eval runs, through the
        engine's buckets."""
        out = self.sm.engine.predict(self._ref_images, generation=None)
        return scoring.score_serving_outputs(self.cfg, out,
                                             self._ref_targets)

    def tick(self) -> Optional[str]:
        """Evaluate one full window if one is buffered. Returns the minted
        `flywheel_id` iff THIS call completed the hysteresis streak;
        otherwise None (including while already triggered). Every evaluated
        window lands one event on the `resilience_` stream."""
        with self._lock:
            if len(self._rows) < self.window_examples:
                return None
            window = np.stack(self._rows[:self.window_examples])
            self._rows.clear()
            trace_ref = self._last_trace_ref
        baseline = self._ensure_baseline()
        mean, std = scoring.input_moments(window)
        input_shift = scoring.moment_shift(self.ref_mean, self.ref_std,
                                           mean, std)
        watch_decay = baseline - self._score_live()
        breach = (input_shift > self.input_gate
                  or watch_decay > self.watch_gate)
        minted: Optional[str] = None
        with self._lock:
            self.windows += 1
            self._last_moments = (mean, std)
            self.last_input_shift = input_shift
            self.last_watch_decay = watch_decay
            if breach:
                self.breaches += 1
                self.consecutive += 1
            else:
                self.consecutive = 0    # hysteresis: streaks only
            if (breach and self.triggered_id is None
                    and self.consecutive >= self.hysteresis_windows):
                minted = f"fw-{uuid.uuid4().hex[:12]}"
                self.triggered_id = minted
            self._events += 1
            step = self._events
        log_resilience_event(
            self.logger, step,
            {"flywheel_window": float(self.windows),
             "flywheel_input_shift": round(input_shift, 4),
             "flywheel_watch_decay": round(watch_decay, 4),
             "flywheel_breach": 1.0 if breach else 0.0,
             **({"flywheel_drift_detected": 1.0} if minted else {})},
            trace_ref=trace_ref,
            flywheel_id=minted or self.triggered_id)
        return minted

    # -- episode lifecycle (called by the flywheel controller) -------------

    def reset_trigger(self) -> None:
        """Clear the trigger and streak WITHOUT moving the reference —
        the failed-episode path: drift is still real, the monitor may
        re-confirm it (a full hysteresis streak again) for the next
        attempt."""
        with self._lock:
            self.triggered_id = None
            self.consecutive = 0
            self._rows.clear()

    def rebaseline(self) -> None:
        """Adopt the last evaluated window's moments as the new input
        reference and re-score the (just promoted) live generation as the
        new watch baseline — the promoted-episode path. Without this the
        same shift re-triggers forever: the model was retrained ON the new
        distribution, so the new distribution is now normal."""
        with self._lock:
            if self._last_moments is not None:
                self.ref_mean, self.ref_std = self._last_moments
            self.triggered_id = None
            self.consecutive = 0
            self._rows.clear()
        self.baseline_watch = self._score_live()

    def describe(self) -> dict:
        """The /healthz drift record (nested under the flywheel entry)."""
        with self._lock:
            return {
                "watch": self.watch_name,
                "baseline_watch": (round(self.baseline_watch, 4)
                                   if self.baseline_watch is not None
                                   else None),
                "window_examples": self.window_examples,
                "input_gate": self.input_gate,
                "watch_gate": self.watch_gate,
                "hysteresis_windows": self.hysteresis_windows,
                "windows": self.windows,
                "breaches": self.breaches,
                "consecutive": self.consecutive,
                "buffered": len(self._rows),
                "last_input_shift": round(self.last_input_shift, 4),
                "last_watch_decay": round(self.last_watch_decay, 4),
                "triggered_id": self.triggered_id,
            }
