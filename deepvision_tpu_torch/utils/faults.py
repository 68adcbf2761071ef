"""Deterministic fault injection for the trainers, the checkpoint layer and
the serving stack (own copy of the trainer, checkpoint, serving-dispatch
and promotion part of deepvision_tpu/utils/faults.py: `FaultInjector` with
the same environment variables and the same parsing).

Every recovery path of core/resilience.py and core/checkpoint.py must be
testable on the CPU without a flaky cluster to provide the faults, so the
injector fakes the failure classes long runs see:

    DEEPVISION_FAULT_DATA_IO_STEP=k[:count]  raise OSError before yielding
                                             batch k (0-based, counted across
                                             the whole process), `count` times
                                             (default 1): transient, retries
                                             eventually succeed
    DEEPVISION_FAULT_NAN_STEP=k              overwrite batch k's images with
                                             NaN, so the step's loss goes
                                             non-finite through the real step
                                             (one-shot)
    DEEPVISION_FAULT_CKPT_SAVE_FAILS=M       raise OSError from the first M
                                             checkpoint save() calls
    DEEPVISION_FAULT_CKPT_ASYNC_FAILS=M      raise OSError inside the first M
                                             background writes: the failure
                                             class the synchronous save's
                                             retry can never see
    DEEPVISION_FAULT_CKPT_CORRUPT=k:mode     after epoch k's save commits
                                             (manifest written), corrupt it on
                                             disk (one-shot). mode: `truncate`
                                             (halve the largest payload file),
                                             `bitflip` (flip one bit in its
                                             middle), `delete_manifest` (what
                                             a kill between the data commit
                                             and the manifest commit leaves)
    DEEPVISION_FAULT_SERVE_DISPATCH_FAIL=k[:n]
                                             fail n consecutive serving
                                             dispatches starting at dispatch
                                             k (0-based, counted per
                                             DynamicBatcher across all its
                                             workers; n defaults to 1): the
                                             batch's futures get the error
                                             and the model's circuit breaker
                                             sees exactly n consecutive
                                             failures
    DEEPVISION_FAULT_PROMOTE_REGRESS=k:kind  make candidate epoch k a
                                             regression when the promotion
                                             controller evaluates it. kind:
                                             `accuracy` (its shadow score is
                                             lowered: the gate must refuse),
                                             `latency` (its dispatches pay an
                                             injected delay: the canary must
                                             roll back). Fires for every
                                             evaluation of epoch k: the
                                             refusal cache, not the injector,
                                             stops re-evaluation
    DEEPVISION_FAULT_REPLICA_CRASH=k         the serving replica process
                                             hard-exits (os._exit(86): no
                                             drain, no atexit) on the
                                             predict request after it has
                                             answered k: the replica that
                                             died mid-request, which the
                                             tier router (serve/tier.py)
                                             ejects on the spot, retries
                                             elsewhere and respawns
    DEEPVISION_FAULT_REPLICA_WEDGE=k         after k answered predict
                                             requests the replica stops
                                             answering but keeps its
                                             socket: every later request,
                                             health probes included, blocks
                                             forever, which only a
                                             deadline-bounded probe tells
                                             from "slow"
    DEEPVISION_FAULT_DRIFT_SHIFT=w:mag       every serving input the
                                             flywheel's drift monitor
                                             (flywheel/drift.py) samples
                                             from its window w on (0-based)
                                             is shifted by the constant
                                             `mag` before it enters the live
                                             statistics. Not one-shot: real
                                             drift persists, and the
                                             monitor's consecutive-window
                                             hysteresis trips only on a
                                             shift that stays
    DEEPVISION_FAULT_QUANT_REGRESS=1         the int8 quantization gate
                                             (serve/quantize.py) sees a
                                             REGRESSED int8 score: its
                                             int8 side is lowered by a
                                             fixed amount, so the gate must
                                             refuse int8 and keep bf16
                                             serving (a
                                             resilience_quant_refused event
                                             and the /healthz decision).
                                             Fires on every gate
                                             evaluation while set

`tamper_sharding`, the JAX package's fourth mode, edits a manifest's mesh
section, which only an elastic (resharding) restore reads; the port keeps
no such section yet, so the mode is refused by name.

An unset environment yields an inert injector (`active` False) whose hooks
are cheap no-ops.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional, Tuple

import numpy as np

CORRUPT_MODES = ("truncate", "bitflip", "delete_manifest", "tamper_sharding")
PROMOTE_REGRESS_KINDS = ("accuracy", "latency")


def _parse_step_count(raw: Optional[str]) -> Tuple[Optional[int], int]:
    if not raw:
        return None, 0
    step, _, count = raw.partition(":")
    return int(step), int(count) if count else 1


def _parse_epoch_mode(raw: Optional[str]
                      ) -> Tuple[Optional[int], Optional[str]]:
    if not raw:
        return None, None
    epoch, _, mode = raw.partition(":")
    mode = mode or "bitflip"
    if mode not in CORRUPT_MODES:
        raise ValueError(f"DEEPVISION_FAULT_CKPT_CORRUPT mode must be one of "
                         f"{CORRUPT_MODES}, got {mode!r}")
    if mode == "tamper_sharding":
        raise NotImplementedError(
            "DEEPVISION_FAULT_CKPT_CORRUPT mode 'tamper_sharding' edits the "
            "manifest's mesh section, which the port does not write until "
            "elastic resharding is ported (ROADMAP A6)")
    return int(epoch), mode


def _parse_promote_regress(raw: Optional[str]
                           ) -> Tuple[Optional[int], Optional[str]]:
    if not raw:
        return None, None
    epoch, _, kind = raw.partition(":")
    kind = kind or "accuracy"
    if kind not in PROMOTE_REGRESS_KINDS:
        raise ValueError(f"DEEPVISION_FAULT_PROMOTE_REGRESS kind must be one "
                         f"of {PROMOTE_REGRESS_KINDS}, got {kind!r}")
    return int(epoch), kind


def _parse_drift_shift(raw: Optional[str]) -> Tuple[Optional[int], float]:
    if not raw:
        return None, 0.0
    window, _, magnitude = raw.partition(":")
    try:
        w = int(window)
    except ValueError:
        raise ValueError(
            f"DEEPVISION_FAULT_DRIFT_SHIFT window must be an int "
            f"(got {window!r}); expected <window>:<magnitude>")
    if not magnitude:
        raise ValueError(
            "DEEPVISION_FAULT_DRIFT_SHIFT needs an explicit magnitude "
            "(<window>:<magnitude>) — a zero-magnitude shift would arm a "
            "fault that can never fire")
    try:
        m = float(magnitude)
    except ValueError:
        raise ValueError(
            f"DEEPVISION_FAULT_DRIFT_SHIFT magnitude must be a float "
            f"(got {magnitude!r}); expected <window>:<magnitude>")
    if m == 0.0:
        raise ValueError(
            "DEEPVISION_FAULT_DRIFT_SHIFT magnitude must be non-zero — a "
            "zero shift arms a fault that can never fire")
    return w, m


class FaultInjector:
    """Process-local fault state: counters advance as the hooks are called,
    so a fault fires at a deterministic batch or save index and then
    clears."""

    def __init__(self, data_io_step: Optional[int] = None,
                 data_io_count: int = 1,
                 nan_step: Optional[int] = None,
                 ckpt_save_fails: int = 0,
                 ckpt_async_fails: int = 0,
                 ckpt_corrupt_epoch: Optional[int] = None,
                 ckpt_corrupt_mode: Optional[str] = None,
                 promote_regress_epoch: Optional[int] = None,
                 promote_regress_kind: Optional[str] = None,
                 drift_shift_window: Optional[int] = None,
                 drift_shift_magnitude: float = 0.0,
                 quant_regress: bool = False,
                 serve_dispatch_fail_at: Optional[int] = None,
                 serve_dispatch_fail_count: int = 1,
                 replica_crash_after: Optional[int] = None,
                 replica_wedge_after: Optional[int] = None):
        self.data_io_step = data_io_step
        self.data_io_remaining = (data_io_count if data_io_step is not None
                                  else 0)
        self.nan_step = nan_step
        self.ckpt_save_fails = ckpt_save_fails
        self.ckpt_async_fails = ckpt_async_fails
        self.ckpt_corrupt_epoch = ckpt_corrupt_epoch
        self.ckpt_corrupt_mode = ckpt_corrupt_mode
        self.promote_regress_epoch = promote_regress_epoch
        self.promote_regress_kind = promote_regress_kind
        self.drift_shift_window = drift_shift_window
        self.drift_shift_magnitude = (float(drift_shift_magnitude)
                                      if drift_shift_window is not None
                                      else 0.0)
        self.quant_regress = bool(quant_regress)
        self.serve_dispatch_fail_at = serve_dispatch_fail_at
        self.serve_dispatch_fail_count = (serve_dispatch_fail_count
                                          if serve_dispatch_fail_at is not None
                                          else 0)
        self.replica_crash_after = replica_crash_after
        self.replica_wedge_after = replica_wedge_after
        self._batch_index = 0   # advances once per batch pulled
        self._save_index = 0
        self._async_index = 0
        self._serve_dispatch_index = 0
        self._replica_requests = 0   # predict requests answered so far
        self._replica_wedged = False
        # serving dispatches and HTTP handlers run on many threads: the
        # serving hooks' counters are locked
        self._serve_lock = threading.Lock()

    @classmethod
    def from_env(cls, env=None) -> "FaultInjector":
        env = os.environ if env is None else env
        io_step, io_count = _parse_step_count(
            env.get("DEEPVISION_FAULT_DATA_IO_STEP"))
        nan_step, _ = _parse_step_count(env.get("DEEPVISION_FAULT_NAN_STEP"))
        corrupt_epoch, corrupt_mode = _parse_epoch_mode(
            env.get("DEEPVISION_FAULT_CKPT_CORRUPT"))
        regress_epoch, regress_kind = _parse_promote_regress(
            env.get("DEEPVISION_FAULT_PROMOTE_REGRESS"))
        drift_window, drift_magnitude = _parse_drift_shift(
            env.get("DEEPVISION_FAULT_DRIFT_SHIFT"))
        quant_regress = env.get("DEEPVISION_FAULT_QUANT_REGRESS",
                                "") not in ("", "0")
        dispatch_at, dispatch_count = _parse_step_count(
            env.get("DEEPVISION_FAULT_SERVE_DISPATCH_FAIL"))
        crash_raw = env.get("DEEPVISION_FAULT_REPLICA_CRASH")
        wedge_raw = env.get("DEEPVISION_FAULT_REPLICA_WEDGE")
        return cls(data_io_step=io_step, data_io_count=io_count,
                   nan_step=nan_step,
                   ckpt_save_fails=int(
                       env.get("DEEPVISION_FAULT_CKPT_SAVE_FAILS", "0")),
                   ckpt_async_fails=int(
                       env.get("DEEPVISION_FAULT_CKPT_ASYNC_FAILS", "0")),
                   ckpt_corrupt_epoch=corrupt_epoch,
                   ckpt_corrupt_mode=corrupt_mode,
                   promote_regress_epoch=regress_epoch,
                   promote_regress_kind=regress_kind,
                   drift_shift_window=drift_window,
                   drift_shift_magnitude=drift_magnitude,
                   quant_regress=quant_regress,
                   serve_dispatch_fail_at=dispatch_at,
                   serve_dispatch_fail_count=dispatch_count,
                   replica_crash_after=(int(crash_raw) if crash_raw
                                        else None),
                   replica_wedge_after=(int(wedge_raw) if wedge_raw
                                        else None))

    @property
    def active(self) -> bool:
        return (self.data_io_step is not None or self.nan_step is not None
                or self.ckpt_save_fails > 0 or self.ckpt_async_fails > 0
                or self.ckpt_corrupt_epoch is not None
                or self.promote_regress_epoch is not None
                or self.drift_shift_window is not None
                or self.quant_regress
                or self.serve_dispatch_fail_at is not None
                or self.replica_crash_after is not None
                or self.replica_wedge_after is not None)

    # -- hooks -----------------------------------------------------------
    def before_batch(self) -> None:
        """Called before pulling the next batch from the source iterator.
        Raises the configured transient OSError without advancing the batch
        index, so a retry faces the remaining fault budget and then pulls
        the batch the source never lost."""
        if (self.data_io_remaining > 0
                and self._batch_index == self.data_io_step):
            self.data_io_remaining -= 1
            raise OSError(
                f"injected transient I/O error at batch {self._batch_index} "
                f"({self.data_io_remaining} more to come)")

    def poison_batch(self, batch):
        """Called with the pulled batch; advances the batch index. At the
        configured step the first array (the images, by every family's
        batch contract; the batch itself where it is one bare array, as
        the DCGAN pipeline's) becomes float32 NaN of the same shape, so the
        loss goes non-finite through the real step. The staging and the
        steps take float32 images where they take uint8 ones: every step
        casts to f32 before it scales or normalizes, and NaN survives
        every such operation."""
        i = self._batch_index
        self._batch_index += 1
        if self.nan_step is None or i != self.nan_step:
            return batch
        self.nan_step = None  # one-shot: the retried epoch trains clean
        if isinstance(batch, np.ndarray):
            return np.full_like(batch, np.nan, dtype=np.float32)
        batch = tuple(batch)
        poisoned = np.full_like(np.asarray(batch[0], dtype=np.float32),
                                np.nan)
        return (poisoned,) + batch[1:]

    def before_checkpoint_save(self) -> None:
        """Called at the top of every checkpoint save; the first M calls
        raise a transient OSError."""
        i = self._save_index
        self._save_index += 1
        if i < self.ckpt_save_fails:
            raise OSError(
                f"injected transient checkpoint-write failure "
                f"({i + 1}/{self.ckpt_save_fails})")

    def during_async_save(self) -> None:
        """Called from the checkpoint writer thread after save() returned;
        the first M calls raise: the background failure that must surface
        at the next save()/flush() rather than at close()."""
        i = self._async_index
        self._async_index += 1
        if i < self.ckpt_async_fails:
            raise OSError(
                f"injected async checkpoint-write failure "
                f"({i + 1}/{self.ckpt_async_fails})")

    def before_serve_dispatch(self) -> None:
        """Called by DynamicBatcher._dispatch right before the engine call:
        dispatches [k, k+n) raise, so the batch's futures carry the error
        and the circuit breaker sees exactly n consecutive failures. The
        index counts every dispatch of the owning batcher, all workers,
        under a lock."""
        if self.serve_dispatch_fail_at is None:
            return
        with self._serve_lock:
            i = self._serve_dispatch_index
            self._serve_dispatch_index += 1
        lo = self.serve_dispatch_fail_at
        if lo <= i < lo + self.serve_dispatch_fail_count:
            raise RuntimeError(
                f"injected serving dispatch failure "
                f"{i - lo + 1}/{self.serve_dispatch_fail_count} "
                f"(dispatch {i})")

    def on_replica_request(self, predict: bool = True) -> None:
        """Called by the HTTP front door (serve/server.py) at the top of
        every request. Predict requests advance the replica's request
        counter; once it passes the armed threshold the process either
        hard-exits (`REPLICA_CRASH`: os._exit, so the client mid-request
        sees a reset and later connects are refused, which is what a
        SIGKILLed replica looks like to the tier router) or wedges
        (`REPLICA_WEDGE`: this and every later handler thread, health
        probes included, blocks forever while the listener keeps
        accepting). Other requests never advance the counter, so a
        router's health-poll cadence does not change when the fault
        fires, but they hang once the replica is wedged."""
        crash, wedge = self.replica_crash_after, self.replica_wedge_after
        if crash is None and wedge is None:
            return
        with self._serve_lock:
            if predict and not self._replica_wedged:
                n = self._replica_requests   # answered so far
                self._replica_requests += 1
                if crash is not None and n >= crash:
                    print(f"[faults] replica hard-exit after {crash} "
                          f"answered predict requests", file=sys.stderr,
                          flush=True)
                    os._exit(86)
                if wedge is not None and n >= wedge:
                    print(f"[faults] replica wedged after {wedge} answered "
                          f"predict requests — holding the socket, "
                          f"answering nothing", file=sys.stderr, flush=True)
                    self._replica_wedged = True
            hang = self._replica_wedged
        if hang:
            while True:      # hold the connection open, never answer
                time.sleep(3600)

    def promote_regression(self, epoch: Optional[int]) -> Optional[str]:
        """Called by the promotion controller when candidate `epoch` enters
        evaluation: the injected regression kind (`accuracy` / `latency`)
        when `epoch` is the armed one, else None. Not one-shot: the same
        bad epoch regresses on every evaluation, so a test can prove that
        the controller's refusal cache stops re-evaluation."""
        if epoch is None or epoch != self.promote_regress_epoch:
            return None
        return self.promote_regress_kind

    def drift_shift(self, window_index: int) -> float:
        """Called by the flywheel's drift monitor as each sampled serving
        input enters its live window: the constant to add to the sample
        once window `window_index` has reached the armed one, else 0.0.
        Not one-shot, as real drift persists."""
        if (self.drift_shift_window is None
                or window_index < self.drift_shift_window):
            return 0.0
        return self.drift_shift_magnitude

    def quant_regression(self) -> bool:
        """Called by the int8 quantization gate (serve/quantize.py) when it
        scores int8 against bf16: True while
        DEEPVISION_FAULT_QUANT_REGRESS is armed, and the gate then lowers
        the int8 score by `FAULT_SCORE_DROP`."""
        return self.quant_regress

    def corrupt_checkpoint(self, epoch: int, step_dir: str,
                           manifest_name: str = "integrity_manifest.json"
                           ) -> None:
        """Called after epoch `epoch`'s save fully committed (data and
        manifest on disk): corrupt it deterministically (one-shot; the
        largest payload file, its path as the tiebreak)."""
        if self.ckpt_corrupt_epoch is None or epoch != self.ckpt_corrupt_epoch:
            return
        mode = self.ckpt_corrupt_mode
        self.ckpt_corrupt_epoch = None
        if mode == "delete_manifest":
            target = os.path.join(step_dir, manifest_name)
            os.remove(target)
        else:
            candidates = sorted(
                (os.path.join(root, f)
                 for root, _, files in os.walk(step_dir) for f in files
                 if f != manifest_name),
                key=lambda p: (os.path.getsize(p), p))
            target = candidates[-1]
            if mode == "truncate":
                with open(target, "r+b") as fp:
                    fp.truncate(max(1, os.path.getsize(target) // 2))
            else:  # bitflip
                with open(target, "r+b") as fp:
                    fp.seek(os.path.getsize(target) // 2)
                    byte = fp.read(1) or b"\x00"
                    fp.seek(-len(byte), 1)
                    fp.write(bytes([byte[0] ^ 0x80]))
        print(f"[faults] corrupted checkpoint epoch {epoch} ({mode}: "
              f"{os.path.relpath(target, step_dir)})",
              file=sys.stderr, flush=True)
