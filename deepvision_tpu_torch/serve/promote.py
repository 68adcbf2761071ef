"""Accuracy-gated train→serve promotion: shadow eval, canary, auto-rollback
(port of deepvision_tpu/serve/promote.py).

Hot reload (serve/reload.py) alone promotes a candidate checkpoint on
integrity: a manifest that hashes clean ships to all traffic. That catches
corrupt bytes, not a training run that quietly regressed. This module puts
a staged pipeline between them, built from parts the serving stack has:
the engine hosts two weight generations (`PredictEngine.stage_candidate`,
each its own module), the batcher never mixes generations inside a batch,
and every decision lands on the `resilience_` stream.

Per candidate epoch, `PromotionController.propose` runs four stages:

1. **Shadow.** The verified candidate is staged beside the live weights,
   off the request path, and a PINNED eval shard (core/scoring.py) is
   replayed through both generations. The score is the family's watched
   metric (top-1 for classification, mIoU for segmentation, the box-count
   and PCK proxies for the rest).
2. **Gate.** Promote only if `candidate - live >= gate_min_delta` (default
   -0.02: at most 2 points worse). A refusal drops the candidate, logs the
   decision, and is CACHED by the reloader so the epoch is never scored
   again.
3. **Canary.** A fraction of live traffic is routed to the candidate
   (`route()` tags submissions; the batcher builds per-generation batches)
   for a window, comparing canary and baseline dispatch times and error
   rates.
4. **Promote or auto-rollback.** On success the live reference flips
   (`promote_candidate`, one assignment); on a regression, or a shutdown
   mid-canary, the controller retreats to the incumbent
   (`drop_candidate`). Batches in flight finish on one generation either
   way.

Deterministic failure injection for both negative paths:
`DEEPVISION_FAULT_PROMOTE_REGRESS=<epoch>:accuracy` lowers the candidate's
shadow score (the gate must refuse); `...=<epoch>:latency` delays every
candidate dispatch (the canary must roll back).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..core import scoring
from ..core.resilience import log_resilience_event
from ..utils.faults import FaultInjector

# decisions `propose` can return, in the order the pipeline can take them
REFUSED_INCOMPATIBLE = "refused_incompatible"
REFUSED_GATE = "refused_gate"
ROLLED_BACK_CANARY = "rolled_back_canary"
ROLLED_BACK_ABORT = "rolled_back_abort"
PROMOTED = "promoted"

# families whose watched metric is computable from the engine's serving
# outputs — since core/scoring.py grew the detection/pose/centernet proxy
# scores (box-count agreement, PCK), that is every servable family; GANs
# have no single serving engine at all
GATED_FAMILIES = scoring.GATED_FAMILIES

# injected candidate-dispatch delay for the `latency` regression kind (the
# JAX package's): large against a dispatch of a served model so the canary
# comparison cannot miss it, small enough to keep tests fast
FAULT_LATENCY_SPIKE_S = 0.05
# the `accuracy` regression kind subtracts this from the candidate's
# shadow score: a deterministic stand-in for a regressed epoch. Unlike the
# JAX package, the result is not floored at 0: with the floor, a candidate
# and an incumbent that both score 0 (a 1000-class model near chance, as
# vit_small is on the pinned shard after a few steps) get a delta of 0 and
# pass any gate below 0, so the fault would not regress anything
FAULT_ACCURACY_DROP = 0.5


def pinned_eval_shard(cfg, engine, *, examples: int = 64,
                      seed: int = scoring.DEFAULT_SHARD_SEED
                      ) -> Tuple[np.ndarray, tuple]:
    """The default pinned shadow-eval shard, `(images, targets)` from
    core/scoring.pinned_shard shaped/dtyped for this engine. Deterministic
    per (config, seed) down to the byte, so live and candidate generations
    are always scored on IDENTICAL inputs — the delta is pure weight
    difference. Production deployments pass a real held-out shard via
    `eval_batch=`; the synthetic default keeps the gate closed-loop
    testable with no data on disk."""
    try:
        return scoring.pinned_shard(
            cfg, image_size=engine.example_shape[0],
            input_dtype=engine.input_dtype, examples=examples, seed=seed)
    except ValueError:
        raise ValueError(
            f"config {cfg.name!r} (family {cfg.family!r}) has no "
            f"predict-side watch metric — accuracy-gated promotion "
            f"supports families {GATED_FAMILIES}; serve this model "
            f"without --promote-gate (integrity-verified hot reload "
            f"still applies)") from None


class PromotionController:
    """Owns one served model's promotion lifecycle. Attaches itself to the
    `ServedModel` (`sm.promoter`) and taps its batcher's per-batch observer
    for the canary comparison; the reloader calls `propose` with a
    verified, deserialized candidate instead of swapping directly.

    `propose` runs on the reloader's poller thread and blocks through the
    canary window — request threads only ever see the cheap `route()` call
    and per-batch observer appends. `abort()` (the server's drain path)
    interrupts a canary immediately and rolls back to the incumbent, so a
    SIGTERM mid-canary drains on exactly the weights that were live before
    the candidate appeared."""

    def __init__(self, sm, *,
                 gate_min_delta: float = -0.02,
                 canary_frac: float = 0.05,
                 canary_window_s: float = 5.0,
                 canary_min_requests: int = 8,
                 p99_factor: float = 1.5,
                 error_rate_delta: float = 0.02,
                 eval_batch: Optional[Tuple] = None,
                 eval_examples: int = 64,
                 logger=None,
                 faults: Optional[FaultInjector] = None,
                 history_limit: int = 32):
        if not 0.0 < canary_frac <= 1.0:
            raise ValueError(f"canary_frac must be in (0, 1], got "
                             f"{canary_frac}")
        if canary_window_s < 0:
            raise ValueError(f"canary_window_s must be >= 0, got "
                             f"{canary_window_s}")
        from ..configs import get_config
        self.sm = sm
        self.cfg = get_config(sm.name)
        if self.cfg.family not in GATED_FAMILIES:
            raise ValueError(
                f"config {sm.name!r} (family {self.cfg.family!r}) is not "
                f"promotion-gatable — supported families: {GATED_FAMILIES}")
        self.gate_min_delta = float(gate_min_delta)
        self.canary_frac = float(canary_frac)
        self.canary_window_s = float(canary_window_s)
        self.canary_min_requests = int(canary_min_requests)
        self.p99_factor = float(p99_factor)
        self.error_rate_delta = float(error_rate_delta)
        self.logger = logger
        self.faults = faults if faults is not None else FaultInjector.from_env()
        self._eval_batch = eval_batch
        self._eval_examples = int(eval_examples)
        self._history_limit = int(history_limit)

        self._lock = threading.Lock()
        self.state = "idle"            # idle | shadow | canary
        self.history: List[dict] = []  # newest-last decision records
        self._events = 0               # step counter for the metrics stream
        self._abort = threading.Event()
        self._route_acc = 0.0
        # canary window accumulators, reset per candidate
        self._obs: dict = {}
        self.shadow_evals = 0          # candidates shadow-scored (test hook)
        # set by the flywheel controller (flywheel/controller.py) around a
        # drift-triggered proposal: the decision record and its event carry
        # the episode id, so the verdict joins the drift event and the
        # fine-tune spans on one key
        self.flywheel_id: Optional[str] = None

        # wire into the serving unit: routing + the per-batch canary tap
        sm.promoter = self
        sm.batcher.observer = self._observe

    # -- request-path hooks (cheap, called per request/batch) --------------

    def route(self) -> Optional[str]:
        """Which generation this request runs on: 'candidate' for the
        canary fraction while a canary is in flight, else None (live).
        Deterministic fractional accumulator, thread-safe."""
        if self.state != "canary":
            return None
        with self._lock:
            if self.state != "canary":
                return None
            self._route_acc += self.canary_frac
            if self._route_acc >= 1.0:
                self._route_acc -= 1.0
                return "candidate"
        return None

    def _observe(self, generation: str, latencies_s, dispatch_s,
                 error, sample=None) -> None:
        """Batcher per-batch tap: accumulate canary-window evidence —
        request latencies, per-batch dispatch times, error counts, each
        attributed to the generation that batch ran on. `sample` (the
        batch's input/output references) is the flywheel drift monitor's
        food, accepted and ignored here."""
        if self.state != "canary":
            return
        with self._lock:
            obs = self._obs
            if not obs:
                return
            key = "candidate" if generation == "candidate" else "live"
            obs[f"{key}_lat"].extend(latencies_s)
            obs[f"{key}_disp"].append(dispatch_s)
            if error is not None:
                obs[f"{key}_err"] += len(latencies_s)

    # -- shadow eval -------------------------------------------------------

    def _eval_shard(self) -> Tuple[np.ndarray, tuple]:
        if self._eval_batch is None:
            self._eval_batch = pinned_eval_shard(
                self.cfg, self.sm.engine, examples=self._eval_examples)
        return self._eval_batch

    def _score(self, generation: Optional[str]) -> float:
        """The family's watched metric for one generation over the pinned
        shard, computed from the engine's SERVING outputs (top-1 from
        logits, mIoU from class-id masks, box-count agreement from decoded
        detections / CenterNet peaks, PCK from pose heatmaps —
        core/scoring.score_serving_outputs), scored on the exact payloads
        clients get. Runs at the model's ACTIVE precision: when the quant
        gate flipped serving to int8, candidates are shadow-scored at int8
        too, on the int8 weights staged with them."""
        images, targets = self._eval_shard()
        out = self.sm.engine.predict(images, generation=generation)
        return scoring.score_serving_outputs(self.cfg, out, targets)

    # -- the pipeline ------------------------------------------------------

    def propose(self, epoch: int, model, provenance: Optional[dict]) -> str:
        """Run the full shadow -> gate -> canary -> promote/rollback
        pipeline for one verified candidate `model` (a module of the
        served architecture, as `engine.load_checkpoint_weights` returns).
        Returns the decision constant; the caller (serve/reload.py) caches
        every refusal/rollback so the epoch is never re-evaluated, and
        counts the outcome on /healthz."""
        t0 = time.monotonic()
        if self._abort.is_set():
            return ROLLED_BACK_ABORT  # draining: don't start a pipeline
        engine = self.sm.engine
        fault_kind = self.faults.promote_regression(epoch)
        # -- stage (signature check: anything else needs a new engine) -----
        try:
            engine.stage_candidate(
                model, provenance,
                inject_delay_s=(FAULT_LATENCY_SPIKE_S
                                if fault_kind == "latency" else 0.0))
        except ValueError as e:
            return self._decide(REFUSED_INCOMPATIBLE, epoch, t0,
                                detail=str(e))
        try:
            # -- shadow: score BOTH generations on the pinned shard --------
            with self._lock:
                self.state = "shadow"
            self.shadow_evals += 1
            metric_live = self._score(None)
            metric_cand = self._score("candidate")
            if fault_kind == "accuracy":
                metric_cand -= FAULT_ACCURACY_DROP
            delta = metric_cand - metric_live
            extra = {"metric_live": round(metric_live, 4),
                     "metric_candidate": round(metric_cand, 4),
                     "metric_delta": round(delta, 4),
                     "watch": scoring.watch_metric_name(self.cfg)}
            if delta < self.gate_min_delta:
                engine.drop_candidate()
                return self._decide(
                    REFUSED_GATE, epoch, t0, extra=extra,
                    detail=f"shadow {extra['watch']} delta {delta:+.4f} "
                           f"below gate {self.gate_min_delta:+.4f}")
            # -- canary: route a fraction of live traffic for the window ---
            with self._lock:
                self._obs = {"live_lat": [], "candidate_lat": [],
                             "live_disp": [], "candidate_disp": [],
                             "live_err": 0, "candidate_err": 0}
                self._route_acc = 0.0
                self.state = "canary"
            deadline = time.monotonic() + self.canary_window_s
            while time.monotonic() < deadline:
                if self._abort.wait(min(0.025, self.canary_window_s or 0.025)):
                    break
            with self._lock:
                self.state = "shadow"   # stop routing before deciding
                obs, self._obs = self._obs, {}
            extra.update(self._canary_summary(obs))
            if self._abort.is_set():
                engine.drop_candidate()
                return self._decide(ROLLED_BACK_ABORT, epoch, t0, extra=extra,
                                    detail="shutdown mid-canary: retreated "
                                           "to the incumbent before drain")
            bad = self._canary_regressed(obs)
            if bad:
                engine.drop_candidate()
                return self._decide(ROLLED_BACK_CANARY, epoch, t0,
                                    extra=extra, detail=bad)
            # -- promote: one reference assignment, fleet-wide -------------
            engine.promote_candidate()
            return self._decide(PROMOTED, epoch, t0, extra=extra)
        except BaseException:
            # a failed pipeline must never leave a half-staged candidate
            engine.drop_candidate()
            with self._lock:
                self.state = "idle"
            raise

    def _canary_summary(self, obs: dict) -> dict:
        out = {"canary_requests": len(obs["candidate_lat"]),
               "baseline_requests": len(obs["live_lat"]),
               "canary_errors": obs["candidate_err"],
               "baseline_errors": obs["live_err"]}
        for key in ("live", "candidate"):
            lat = obs[f"{key}_lat"]
            if lat:
                out[f"{key}_p99_ms"] = round(float(np.percentile(
                    np.asarray(lat, np.float64), 99)) * 1000.0, 3)
            disp = obs[f"{key}_disp"]
            if disp:
                out[f"{key}_dispatch_p50_ms"] = round(float(np.median(
                    np.asarray(disp, np.float64))) * 1000.0, 3)
        return out

    def _canary_regressed(self, obs: dict) -> Optional[str]:
        """The rollback trigger: canary error rate above baseline by more
        than `error_rate_delta`, or candidate dispatch time above
        `p99_factor` x the live generation's. The latency comparison runs
        on per-batch DEVICE DISPATCH time, not request latency: the single
        dispatcher serializes batches, so a slow candidate batch inflates
        the queue wait of every live request behind it (head-of-line
        blocking) and request-level p99s converge — dispatch time is the
        component a generation wholly owns. Needs `canary_min_requests`
        canary samples (tiny samples make noisy quantiles); a window with
        no canary traffic at all decides on the shadow gate alone — no
        live evidence is not negative evidence."""
        n_cand = len(obs["candidate_lat"]) + obs["candidate_err"]
        n_live = len(obs["live_lat"]) + obs["live_err"]
        if n_cand == 0:
            return None
        err_cand = obs["candidate_err"] / n_cand
        err_live = (obs["live_err"] / n_live) if n_live else 0.0
        if err_cand > err_live + self.error_rate_delta:
            return (f"canary error rate {err_cand:.3f} vs baseline "
                    f"{err_live:.3f} (allowed +{self.error_rate_delta})")
        if (len(obs["candidate_lat"]) >= self.canary_min_requests
                and obs["live_disp"] and obs["candidate_disp"]):
            disp_c = float(np.median(
                np.asarray(obs["candidate_disp"], np.float64)))
            disp_l = float(np.median(
                np.asarray(obs["live_disp"], np.float64)))
            if disp_c > self.p99_factor * disp_l:
                return (f"canary dispatch {disp_c * 1000:.1f}ms vs "
                        f"baseline {disp_l * 1000:.1f}ms per batch "
                        f"(allowed {self.p99_factor:g}x)")
        return None

    # -- bookkeeping -------------------------------------------------------

    def _decide(self, decision: str, epoch: int, t0: float, *,
                extra: Optional[dict] = None, detail: str = "") -> str:
        record = {"decision": decision, "epoch": int(epoch),
                  "secs": round(time.monotonic() - t0, 3),
                  "unix": time.time(), **(extra or {})}
        if detail:
            record["detail"] = detail
        flywheel_id = self.flywheel_id
        if flywheel_id is not None:
            record["flywheel_id"] = flywheel_id
        with self._lock:
            self.state = "idle"
            self.history.append(record)
            del self.history[:-self._history_limit]
            self._events += 1
            step = self._events
        metrics = {f"promote_{decision}": 1.0, "promote_epoch": float(epoch)}
        for k in ("metric_delta", "canary_requests"):
            if extra and k in extra:
                metrics[f"promote_{k}"] = float(extra[k])
        log_resilience_event(self.logger, step, metrics,
                             flywheel_id=flywheel_id)
        # stderr like the reload layer: a promotion decision must be loud
        # on the replica that took it, not only in the metrics stream
        print(f"[serve-promote:{self.sm.name}] epoch {epoch}: {decision} "
              f"in {record['secs']:.2f}s"
              + (f" ({detail})" if detail else ""),
              file=sys.stderr, flush=True)
        return decision

    def abort(self) -> None:
        """Interrupt any in-flight pipeline (drain/SIGTERM path): an active
        canary rolls back to the incumbent promptly; later proposals are
        refused until the flag is cleared. Idempotent."""
        self._abort.set()

    def describe(self) -> dict:
        """The /healthz promotion record: live state, knobs, and the
        decision history (newest last)."""
        with self._lock:
            return {
                "state": self.state,
                "gate_min_delta": self.gate_min_delta,
                "canary_frac": self.canary_frac,
                "canary_window_s": self.canary_window_s,
                "decisions": [dict(r) for r in self.history],
            }


def attach_promoters(fleet, *, gate_min_delta: float,
                     canary_frac: float, canary_window_s: float,
                     logger=None,
                     warn: Callable[[str], None] = None) -> int:
    """Attach a PromotionController to every workdir-backed, gatable model
    in the fleet (the serve CLI's `--promote-gate` wiring). Non-gatable
    families and static-weight models are skipped with a warning — they
    keep the plain integrity-verified reload path. Returns how many models
    got a controller."""
    n = 0
    for sm in fleet:
        if not sm.workdir:
            continue
        try:
            PromotionController(
                sm, gate_min_delta=gate_min_delta, canary_frac=canary_frac,
                canary_window_s=canary_window_s, logger=logger)
            n += 1
        except ValueError as e:
            if warn is not None:
                warn(f"[serve:{sm.name}] promotion gate skipped: {e}")
    return n
