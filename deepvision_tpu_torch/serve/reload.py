"""Hot weight reload: new verified checkpoints swap in with zero downtime
(port of deepvision_tpu/serve/reload.py).

Training keeps committing epochs into a run dir the fleet serves from. A
background poller (or one synchronous sweep, `POST /reload`) watches each
served model's `<workdir>/ckpt` for committed epochs newer than the live
weights, and for the newest candidate:

1. **Verify first, cheaply.** `core/integrity.verify_epoch` checks the
   manifest at the file level, no deserialization. A CORRUPT candidate is
   refused and cached (logged loudly, counted on /healthz, written to the
   `resilience_` stream) while the old weights keep serving; a
   MISSING_MANIFEST candidate is not ready yet (the manifest is written
   after the data), so the poller waits.
2. **Deserialize off the request path.** The candidate restores through
   the config's own trainer with strict verification
   (`engine.load_checkpoint_weights`, the path startup uses: the per-leaf
   hash check, the EMA weights winning), on the poller thread.
3. **Swap atomically.** `PredictEngine.swap_variables` stages the new
   module on the device, checks it against the served signature (same
   names, shapes and dtypes) and flips one reference; batches in flight
   finish on the old weights. /healthz provenance advances with it.

A candidate whose shapes changed is refused as incompatible: that needs a
new engine process, not a swap.

When a served model carries a PromotionController (serve/promote.py, the
`--promote-gate` deployment), step 3 is delegated: the verified candidate
runs the shadow gate and the canary, and the reloader records the verdict
— a refused or rolled-back epoch joins the same refusal cache as a corrupt
one, so a bad epoch is hashed, restored and scored exactly once.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, Iterable, Optional, Set

from ..core import integrity
from ..core.checkpoint import CheckpointCorruptionError
from ..core.resilience import log_resilience_event
from . import promote
from .engine import load_checkpoint_weights
from .fleet import ServedModel


def _log(name: str, msg: str) -> None:
    # stderr like the checkpoint layer: reload outcomes must be loud on the
    # replica that took them, not only in the metrics stream
    print(f"[serve-reload:{name}] {msg}", file=sys.stderr, flush=True)


class WeightReloader:
    """Background poller over the fleet's workdir-backed models.

    `start()` spawns the daemon thread (`poll_every_s` cadence);
    `check_once()` runs one full sweep synchronously — `POST /reload` and
    the tests' handle, and exactly what the thread calls. `stop()` joins.
    One reloader serves the whole fleet: candidate restores are serialized
    on the poller thread by construction, so two models' reloads never
    hash/deserialize concurrently with each other (they do run concurrently
    with request traffic — that is the point)."""

    def __init__(self, models: Iterable[ServedModel], *,
                 poll_every_s: float = 10.0,
                 logger=None, verify: bool = True):
        self.models = [sm for sm in models if sm.workdir]
        self.poll_every_s = float(poll_every_s)
        self.logger = logger        # MetricsLogger for the resilience_ stream
        self.verify = verify
        # per-model epochs permanently refused (corrupt / incompatible):
        # re-verifying a known-bad candidate every poll would hash the same
        # bad bytes forever
        self._refused: Dict[str, Set[int]] = {sm.name: set()
                                              for sm in self.models}
        self._waiting_logged: Dict[str, Set[int]] = {sm.name: set()
                                                     for sm in self.models}
        self._events = 0            # step counter for the metrics stream
        # serializes sweeps: the poller and `POST /reload` both call
        # check_once, and two sweeps racing would evaluate one epoch twice
        self._sweep_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "WeightReloader":
        if self._thread is None and self.models and self.poll_every_s > 0:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="weight-reloader")
            self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_every_s):
            try:
                self.check_once()
            except Exception as e:  # noqa: BLE001 — the poller must survive
                # transient filesystem weirdness; the next tick retries
                _log("fleet", f"poll failed (will retry): {e!r}")

    # -- one sweep ---------------------------------------------------------

    def check_once(self) -> int:
        """Sweep every watched model once; returns how many swaps landed."""
        swapped = 0
        with self._sweep_lock:
            # the lock serializes whole sweeps, restores included: a second
            # caller waits for the first sweep's verdicts, then finds the
            # epoch swapped or cached instead of evaluating it again
            for sm in self.models:
                if self._check_model(sm):  # jaxlint: disable=LCK004
                    swapped += 1
        return swapped

    def _current_epoch(self, sm: ServedModel) -> int:
        got = sm.engine.provenance.get("checkpoint_epoch")
        return -1 if got is None else int(got)  # random-init: anything wins

    def _check_model(self, sm: ServedModel) -> bool:
        ckpt_dir = os.path.join(sm.workdir, "ckpt")
        current = self._current_epoch(sm)
        refused = self._refused[sm.name]
        candidates = [e for e in integrity.committed_epochs(ckpt_dir)
                      if e > current and e not in refused]
        if not candidates:
            return False
        epoch = max(candidates)   # newest first; older ones are stale news
        status, detail, _ = integrity.verify_epoch(ckpt_dir, epoch)
        if status == integrity.MISSING_MANIFEST:
            # the writer commits the manifest AFTER the data:
            # mid-save, not corruption — wait for the next poll (log once)
            if epoch not in self._waiting_logged[sm.name]:
                self._waiting_logged[sm.name].add(epoch)
                _log(sm.name, f"epoch {epoch} committed but not yet "
                              f"manifested — waiting for the save to "
                              f"finalize")
            return False
        if status != integrity.OK:
            self._refuse(sm, epoch, "refused_corrupt",
                         f"candidate epoch {epoch} failed integrity "
                         f"verification ({detail}) — NOT swapped; old "
                         f"weights keep serving. Audit with `python -m "
                         f"deepvision_tpu_torch fsck {ckpt_dir}`")
            return False
        # file-verified: deserialize + deep-verify off the request path
        try:
            model, provenance, _ = load_checkpoint_weights(
                sm.name, sm.workdir, checkpoint=epoch, verify=self.verify,
                verbose=False, image_size=sm.engine.example_shape[0])
        except (CheckpointCorruptionError, FileNotFoundError, OSError,
                ValueError) as e:
            self._refuse(sm, epoch, "refused_corrupt",
                         f"candidate epoch {epoch} failed strict restore "
                         f"({e}) — NOT swapped; old weights keep serving")
            return False
        except RuntimeError as e:
            # load_state_dict's refusal: a checkpoint of another
            # architecture in the same run dir
            self._refuse(sm, epoch, "refused_incompatible",
                         f"candidate epoch {epoch} does not fit the served "
                         f"architecture ({str(e).splitlines()[0]}...) — NOT "
                         f"swapped; old weights keep serving")
            return False
        promoter = sm.promoter
        if promoter is not None:
            # accuracy-gated promotion (serve/promote.py): the controller
            # runs shadow eval, the metric-delta gate, and the canary
            # window, and flips or retreats itself — the reloader's job
            # reduces to caching the verdict so a refused/rolled-back
            # epoch is never re-evaluated, and counting it on /healthz.
            decision = promoter.propose(epoch, model, provenance)
            if decision == promote.ROLLED_BACK_ABORT:
                return False   # shutting down: not the epoch's fault —
                               # don't cache, a restart may re-evaluate
            if decision != promote.PROMOTED:
                counter = {promote.REFUSED_GATE: "refused_gate",
                           promote.ROLLED_BACK_CANARY: "rolled_back"}.get(
                    decision, "refused_incompatible")
                record = (promoter.history[-1] if promoter.history else {})
                detail = record.get("detail",
                                    "see /healthz promotion history")
                incumbent = current if current >= 0 else "random-init"
                self._refuse(sm, epoch, counter,
                             f"candidate epoch {epoch} {decision} "
                             f"({detail}) — incumbent epoch {incumbent} "
                             f"keeps serving")
                return False
        else:
            try:
                sm.engine.swap_variables(model, provenance=provenance)
            except ValueError as e:
                self._refuse(sm, epoch, "refused_incompatible", str(e))
                return False
        with sm.reload_lock:
            sm.reload_stats["reloads"] += 1
            sm.reload_stats["last_reload_epoch"] = float(epoch)
            sm.reload_stats["last_reload_unix"] = time.time()
        self._event({"reload_swapped": 1.0, "reload_epoch": float(epoch)})
        incumbent = current if current >= 0 else "random-init"
        _log(sm.name, f"hot-swapped weights: epoch {incumbent} -> {epoch} "
                      f"(manifest "
                      f"{(provenance.get('manifest_sha256') or '')[:12]}, "
                      f"verified={provenance.get('verified')}"
                      + (", promoted through the shadow/canary gate"
                         if promoter is not None else "")
                      + (", re-quantized under the pinned int8 scales"
                         if sm.engine.int8_enabled else "")
                      + ")")
        return True

    def _refuse(self, sm: ServedModel, epoch: int, counter: str,
                msg: str) -> None:
        self._refused[sm.name].add(epoch)
        with sm.reload_lock:
            sm.reload_stats[counter] += 1
        self._event({f"reload_{counter}": 1.0,
                     "reload_refused_epoch": float(epoch)})
        _log(sm.name, msg)

    def _event(self, metrics: dict) -> None:
        self._events += 1
        log_resilience_event(self.logger, self._events, metrics)
