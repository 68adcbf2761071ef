"""The retrain controller: one confirmed drift event → one bounded episode
(port of deepvision_tpu/flywheel/controller.py).

State machine (FLYWHEEL_STATES, one-hot on /metrics):

    monitoring ──drift──> drift_detected ──> finetuning ──> gating ──┐
        ^                                                            │
        │<── promoted (rebaseline, reset backoff) <──────────────────┤
        │<── refused / rolled_back (exponential backoff, retry) <────┤
        │                                                            │
        └───────── circuit_open (max_attempts failures: STOP) <──────┘

Everything downstream of detection is REUSE, not reimplementation:

- **Fine-tune**: a bounded number of epochs through the existing trainer
  family (`trainer_class_for_config`) on the engine's device, resumed from
  the newest committed epoch in the served model's own run dir, on the
  whole-epoch path from the device (`epoch_on_device`, in the cached
  order), or through the staged per-batch loop where the trainer refuses
  that path (`Trainer.train_epoch`). Each retry commits a NEW epoch, so
  the reloader's permanent per-epoch refusal cache never blocks a retry.
- **Gate + canary + rollback**: the committed candidate goes through a
  private `WeightReloader.check_once()` over exactly this model, which
  verifies integrity, restores, and delegates to the
  `PromotionController` (serve/promote.py) — shadow eval on the pinned
  shard, metric-delta gate, canary window, auto-rollback. When the engine
  serves int8, the staged candidate is re-quantized under the pinned
  calibration plan (serve/quantize.py), as in any hot reload: never
  recalibrated.
- **Backoff + circuit**: a refused or rolled-back candidate schedules the
  next attempt at `backoff_base_s * 2^(failures-1)` (capped at
  `backoff_max_s`); `max_attempts` consecutive failures open the retrain
  circuit — the flywheel STOPS retraining, alerts loudly on stderr and
  the resilience stream, and an operator must `reset_circuit()`.

The `flywheel_id` the monitor mints at the drift event is carried through
every resilience event, every span (`flywheel_finetune`/`flywheel_gate`
plus the trainer's own spans via `arm_tracing`), the promotion
controller's decision records, and /healthz — one grep reconstructs the
whole episode.

Serving keeps flowing throughout: fine-tune and gating run on the
flywheel thread (sharing the card with the dispatches); request threads
only ever see the monitor's cheap sample-copy tap and the canary routing
the promotion pipeline already imposes.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Iterable, Optional

from ..core import integrity
from ..core.resilience import log_resilience_event
from ..utils.faults import FaultInjector
from .drift import DriftMonitor

# every state the controller can report, in the JAX package's order
FLYWHEEL_STATES = ("monitoring", "drift_detected", "finetuning", "gating",
                   "promoted", "refused", "rolled_back", "circuit_open")

# promotion decisions that map onto the two failure states
_ROLLBACK_DECISIONS = ("rolled_back_canary", "rolled_back_abort")


class FlywheelController:
    """Owns one served model's drift→retrain→promote loop. Requires the
    model to be workdir-backed (somewhere to commit fine-tuned epochs) and
    promotion-gated (`sm.promoter` — the flywheel never swaps weights
    without the gate). Attaches itself as `sm.flywheel` for /healthz."""

    def __init__(self, sm, monitor: Optional[DriftMonitor] = None, *,
                 finetune_epochs: int = 1,
                 finetune_batches: int = 4,
                 max_attempts: int = 3,
                 backoff_base_s: float = 1.0,
                 backoff_max_s: float = 60.0,
                 tick_every_s: float = 0.5,
                 logger=None, tracer=None,
                 faults: Optional[FaultInjector] = None,
                 **monitor_kwargs):
        if not sm.workdir:
            raise ValueError(
                f"model {sm.name!r} is served with static weights (no "
                f"workdir) — the flywheel needs a run dir to commit "
                f"fine-tuned epochs into")
        if sm.promoter is None:
            raise ValueError(
                f"model {sm.name!r} has no promotion controller — the "
                f"flywheel only ships candidates through the shadow/"
                f"canary gate (arm --promote-gate first)")
        if finetune_epochs < 1:
            raise ValueError(f"finetune_epochs must be >= 1, got "
                             f"{finetune_epochs}")
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{max_attempts}")
        self.sm = sm
        self.finetune_epochs = int(finetune_epochs)
        self.finetune_batches = int(finetune_batches)
        self.max_attempts = int(max_attempts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.tick_every_s = float(tick_every_s)
        self.logger = logger
        self.tracer = tracer
        self.faults = faults if faults is not None else FaultInjector.from_env()
        self.monitor = monitor if monitor is not None else DriftMonitor(
            sm, logger=logger, faults=self.faults, **monitor_kwargs)

        # the gating path: a PRIVATE reloader over exactly this model, so
        # `check_once()` verifies/restores/proposes the freshly committed
        # epoch on the flywheel thread without racing the server's own
        # poller cadence
        from ..serve.reload import WeightReloader
        self._reloader = WeightReloader([sm], poll_every_s=0, logger=logger)

        self._lock = threading.Lock()
        self.state = "monitoring"
        self.failures = 0              # consecutive failed episodes
        self.episodes = 0              # drift events acted on
        self.counters = {"retrains": 0, "promoted": 0, "refused": 0,
                         "rolled_back": 0, "circuit_opened": 0}
        # optimizer steps the fine-tunes ran, counted as they finish
        self.finetune_steps = 0
        self.last_decision: Optional[str] = None
        self.last_flywheel_id: Optional[str] = None
        self._backoff_until = 0.0      # monotonic deadline for next attempt
        self._events = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        sm.flywheel = self

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FlywheelController":
        if self._thread is None and self.tick_every_s > 0:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"flywheel-{self.sm.name}")
            self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_every_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                self._log(f"tick failed (will retry): {e!r}")

    # -- one tick ----------------------------------------------------------

    def tick(self) -> str:
        """One control step: let the monitor evaluate a window; if a drift
        trigger is pending (and the circuit is closed and any backoff has
        expired), run one full episode synchronously. Returns the state
        after the tick — the tests' handle, and exactly what the
        thread calls."""
        if self.state == "circuit_open":
            return self.state
        self.monitor.tick()
        if self.monitor.triggered_id is None:
            if self.state == "monitoring" or self._backing_off():
                return self.state
            # trigger cleared without an episode (operator reset): idle
            self._set_state("monitoring")
            return self.state
        if self._backing_off():
            return self.state
        return self._run_episode(self.monitor.triggered_id)

    def _backing_off(self) -> bool:
        return time.monotonic() < self._backoff_until

    # -- the episode -------------------------------------------------------

    def _run_episode(self, fid: str) -> str:
        with self._lock:
            self.episodes += 1
            self.last_flywheel_id = fid
        self._set_state("drift_detected", fid)
        self._log(f"drift confirmed ({fid}): input_shift="
                  f"{self.monitor.last_input_shift:.3f} watch_decay="
                  f"{self.monitor.last_watch_decay:.3f} — starting a "
                  f"bounded fine-tune (attempt "
                  f"{self.failures + 1}/{self.max_attempts})")
        try:
            self._set_state("finetuning", fid)
            with self._span("flywheel_finetune", fid):
                epoch = self._finetune(fid)
            with self._lock:
                self.counters["retrains"] += 1
            self._set_state("gating", fid,
                            extra={"flywheel_candidate_epoch": float(epoch)})
            promoter = self.sm.promoter
            promoter.flywheel_id = fid
            try:
                with self._span("flywheel_gate", fid, epoch=epoch):
                    swapped = self._reloader.check_once()
            finally:
                promoter.flywheel_id = None
            decision = (promoter.history[-1]["decision"]
                        if promoter.history else None)
        except Exception as e:  # noqa: BLE001 — a failed fine-tune is a
            # failed episode (backoff/circuit), never a dead control loop
            self._log(f"episode {fid} failed before the gate: {e!r}")
            return self._failed(fid, "refused", f"finetune_error: {e!r}")
        with self._lock:
            self.last_decision = decision
        if swapped:
            return self._promoted(fid, epoch)
        if decision in _ROLLBACK_DECISIONS:
            return self._failed(fid, "rolled_back", decision)
        return self._failed(fid, "refused", decision or "no_candidate")

    def _promoted(self, fid: str, epoch: int) -> str:
        with self._lock:
            self.counters["promoted"] += 1
            self.failures = 0
            self._backoff_until = 0.0
        # the retrained weights now DEFINE normal: adopt the drifted
        # window's moments as the reference and re-score the baseline, or
        # the same shift re-triggers forever
        self.monitor.rebaseline()
        self._set_state("promoted", fid,
                        extra={"flywheel_promoted_epoch": float(epoch)})
        self._log(f"episode {fid}: candidate epoch {epoch} PROMOTED "
                  f"through the shadow/canary gate — rebaselined the "
                  f"drift reference; back to monitoring")
        self._set_state("monitoring", fid)
        return "promoted"

    def _failed(self, fid: str, state: str, decision: str) -> str:
        with self._lock:
            self.counters["rolled_back" if state == "rolled_back"
                          else "refused"] += 1
            self.failures += 1
            failures = self.failures
        if failures >= self.max_attempts:
            with self._lock:
                self.counters["circuit_opened"] += 1
            self._set_state("circuit_open", fid,
                            extra={"flywheel_failures": float(failures)})
            self._log(f"episode {fid}: {decision} — {failures} consecutive "
                      f"failed retrain attempts: RETRAIN CIRCUIT OPEN. The "
                      f"flywheel stops retraining this model; the incumbent "
                      f"keeps serving. Investigate the drift + refusals, "
                      f"then reset_circuit() / restart to re-arm.")
            return "circuit_open"
        backoff = min(self.backoff_max_s,
                      self.backoff_base_s * (2.0 ** (failures - 1)))
        with self._lock:
            self._backoff_until = time.monotonic() + backoff
        # drift is still real: keep the trigger armed via a fresh streak so
        # the next attempt re-confirms it instead of firing blind
        self.monitor.reset_trigger()
        self._set_state(state, fid,
                        extra={"flywheel_backoff_s": round(backoff, 3),
                               "flywheel_failures": float(failures)})
        self._log(f"episode {fid}: {decision} — incumbent keeps serving; "
                  f"retry {failures + 1}/{self.max_attempts} in "
                  f"{backoff:.1f}s (exponential backoff)")
        return state

    # -- the bounded fine-tune ---------------------------------------------

    def _finetune(self, fid: str) -> int:
        """Resume the served model's own run dir from its newest committed
        epoch on the engine's device, train `finetune_epochs` more, commit
        them (manifested — core/integrity), and return the newest
        committed epoch number. Runs entirely on the flywheel thread."""
        import os

        from ..configs import trainer_class_for_config

        ckpt_dir = os.path.join(self.sm.workdir, "ckpt")
        committed = integrity.committed_epochs(ckpt_dir)
        base = max(committed) if committed else 0
        trainer_cls = trainer_class_for_config(self.sm.name)
        if trainer_cls is None:
            raise ValueError(f"config {self.sm.name!r} has no supervised "
                             f"trainer — the flywheel cannot fine-tune it")
        trainer = None
        device = self.sm.engine.device
        try:
            try:
                trainer = trainer_cls(self._finetune_config(base),
                                      device=device, workdir=self.sm.workdir)
            except ValueError:
                # the whole-epoch path is ineligible for this config
                # (accumulation, ...): the staged per-batch loop always works
                trainer = trainer_cls(
                    self._finetune_config(base, on_device=False),
                    device=device, workdir=self.sm.workdir)
            if self.tracer is not None:
                trainer.arm_tracing(tracer=self.tracer)
            trainer.init_state()
            got = trainer.resume()
            start = (got + 1) if got is not None else 1
            for ep in range(start, start + self.finetune_epochs):
                with self._span("flywheel_train_epoch", fid, epoch=ep):
                    trainer.train_epoch(ep, self._data(ep))
                with self._lock:
                    self.finetune_steps += len(trainer.last_epoch_steps)
                trainer.ckpt.save(ep, trainer.state.state_dict(),
                                  host_state={"best_metric": 0.0})
                last = ep
            trainer.ckpt.flush()
        finally:
            if trainer is not None:
                # close() would re-export the shared tracer; the server owns
                # that — drop the trace_out handle first
                trainer._trace_out = None
                trainer.close()
        return last

    def _finetune_config(self, base: int, on_device: bool = True):
        """The bounded-budget training config: the model's own config with
        just enough epochs for this episode, a constant LR (a fine-tune
        must not replay the cosine ramp), the whole-epoch path from the
        device when the trainer deems it eligible (in the cached order),
        at the served resolution."""
        import dataclasses

        from ..configs import get_config
        from ..core.config import ScheduleConfig
        cfg = get_config(self.sm.name)
        return cfg.replace(
            total_epochs=base + self.finetune_epochs,
            epoch_on_device=on_device,
            epoch_shuffle=False,
            schedule=ScheduleConfig(name="constant"),
            data=dataclasses.replace(
                cfg.data, image_size=self.sm.engine.example_shape[0]))

    def _data(self, epoch: int) -> Iterable:
        """One epoch's fine-tune batches: a synthetic stream at the
        config's batch, which keeps the loop closed-loop testable with no
        data on disk — same philosophy as the pinned shard."""
        cfg = self.monitor.cfg
        h = self.sm.engine.example_shape[0]
        if cfg.family == "classification":
            from ..data.synthetic import SyntheticClassification
            return SyntheticClassification(
                cfg.batch_size, image_size=h, channels=cfg.data.channels,
                num_classes=cfg.data.num_classes,
                num_batches=self.finetune_batches, seed=epoch)
        if cfg.family == "segmentation":
            from ..data.segmentation import SyntheticSegmentation
            return SyntheticSegmentation(
                cfg.batch_size, image_size=h, channels=cfg.data.channels,
                num_classes=cfg.data.num_classes,
                num_batches=self.finetune_batches, seed=epoch)
        raise ValueError(
            f"no synthetic fine-tune stream for family {cfg.family!r} "
            f"({self.sm.name!r})")

    # -- operator handles --------------------------------------------------

    def reset_circuit(self) -> None:
        """Re-arm an open retrain circuit (operator action after fixing
        whatever made candidates keep failing). Clears the failure streak
        and the monitor's trigger; drift must re-confirm through a full
        hysteresis streak before the next episode."""
        with self._lock:
            self.failures = 0
            self._backoff_until = 0.0
            if self.state == "circuit_open":
                self.state = "monitoring"
        self.monitor.reset_trigger()
        self._log("retrain circuit reset — monitoring")

    def describe(self) -> dict:
        """The /healthz flywheel record: state machine + episode counters
        + the drift monitor's evidence."""
        with self._lock:
            backoff_left = max(0.0, self._backoff_until - time.monotonic())
            return {
                "state": self.state,
                "episodes": self.episodes,
                "failures": self.failures,
                "max_attempts": self.max_attempts,
                "backoff_s": round(backoff_left, 3),
                "counters": dict(self.counters),
                "finetune_steps": self.finetune_steps,
                "last_decision": self.last_decision,
                "flywheel_id": self.last_flywheel_id,
                "drift": self.monitor.describe(),
            }

    # -- plumbing ----------------------------------------------------------

    def _set_state(self, state: str, fid: Optional[str] = None,
                   extra: Optional[dict] = None) -> None:
        assert state in FLYWHEEL_STATES, state
        with self._lock:
            self.state = state
            self._events += 1
            step = self._events
        log_resilience_event(
            self.logger, step,
            {f"flywheel_{state}": 1.0, **(extra or {})},
            flywheel_id=fid)

    def _span(self, name: str, fid: str, **args):
        """A controller span carrying the episode id; a no-op context when
        the server runs without tracing."""
        if self.tracer is not None and self.tracer.enabled:
            return self.tracer.span(name, cat="flywheel",
                                    flywheel_id=fid, model=self.sm.name,
                                    **args)
        import contextlib
        return contextlib.nullcontext({})

    def _log(self, msg: str) -> None:
        # stderr like the reload/promote layers: flywheel decisions must be
        # loud on the replica that took them
        print(f"[flywheel:{self.sm.name}] {msg}", file=sys.stderr,
              flush=True)


def attach_flywheels(fleet, *, logger=None, tracer=None,
                     warn: Optional[Callable[[str], None]] = None,
                     **kwargs) -> int:
    """Attach a FlywheelController to every promotion-gated, workdir-backed
    model in the fleet (the serve CLI's `--flywheel-every` wiring). Models
    that don't qualify are skipped with a warning — they keep whatever
    reload/promotion path they already have. Returns how many models got a
    controller (callers `start()` them)."""
    n = 0
    for sm in fleet:
        try:
            FlywheelController(sm, logger=logger, tracer=tracer, **kwargs)
            n += 1
        except ValueError as e:
            if warn is not None:
                warn(f"[serve:{sm.name}] flywheel skipped: {e}")
    return n
