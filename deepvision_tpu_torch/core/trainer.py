"""The trainers (own copy of deepvision_tpu/core/trainer.py: `Trainer`,
the classification trainer with its state, optimizer, staged epoch loop,
masked evaluation, fit loop, checkpoint and resume; and
`LossWatchedTrainer`).

`Trainer` installs the classification steps (core/steps.py), with the
device augmentation when `config.device_augment` is set; a family
subclass installs its own `train_step(state, *batch) -> metrics` and
`eval_step(state, *batch)`, plain functions on tensors
(core/detection.py). A producer thread stages the host batches on the
device `config.prefetch_batches` ahead (parallel/prefetch.py); the loop
runs the step on each, updates the EMA of the parameters after each
applied optimizer update (`config.ema_decay`), and keeps the metrics on
the device; it reads them back at the `log_every_steps` boundaries and
once at the end of the epoch. Evaluation, and so the best checkpoint,
uses the EMA parameters when there are any. A workdir's `model_kwargs.json`
pins the architecture its weights fit (`apply_pinned_model_kwargs`): a
trainer built on it without a model builds that one.

Under a process group (parallel/mesh.py, a torchrun launch) the trainer is
data-parallel with the JAX mesh's semantics: `batch_size` and
`eval_batch_size` are global and must divide the world size; each rank
trains on its `batch_size // world` rows (its data pipeline makes only
those) and the linear LR scaling still reads the global batch. Evaluation
takes the global batches, pads a partial one to a multiple of the world
size and gives each rank its rows with their mask; the sums are
all-reduced. Every decision (the halt on a non-finite loss, the best
metric, the plateau's scale, the preemption stop) is reached from
all-reduced values, so all ranks take it alike. Rank 0 alone prints, logs
and writes the checkpoints; every rank waits for the writes at each
`flush()` and restore, and all of them resume.

Resilience (core/resilience.py, core/checkpoint.py, utils/faults.py), as
the JAX trainer's:
- the host pull runs under `resilient_batches` inside the prefetch
  thread: a transient OSError is retried with backoff, and the fault
  injector's failed pulls and poisoned (NaN) batches are staged like any
  other batch;
- checkpoints are saved asynchronously (a host snapshot, then a writer
  thread) with an integrity manifest, and restored verified
  (`config.resume_verify`); `fit` ends with `flush()`;
- a non-finite epoch is rolled back to the last committed checkpoint
  (parameters, optimizer moments and counters, BatchNorm statistics, EMA,
  plateau state) and retried with the LR scaled by
  `config.recovery_lr_factor`, up to `config.recover_on_divergence`
  times; the scale persists and composes with the plateau's;
- SIGTERM/SIGINT finish the step in flight, commit the epoch
  synchronously and raise `PreemptionExit` (exit 0 through
  `fit_and_close`);
- `config.watchdog_secs` arms a `StepWatchdog` that is fed when a step's
  completion reaches the host: on the card when the step's CUDA event has
  completed (polled without blocking), never at its enqueue;
- every recovery writes a `resilience_*` event to the metrics stream.

The training step's levers, as the JAX trainer's: `remat` (the state's
`Remat`), `mixup_alpha` / `cutmix_alpha` and `log_grad_norm` (the
classification step; every family's step takes the gradient norm),
`steps_per_dispatch` (k staged batches a dispatch, metrics read and
logged per dispatch as the k steps' mean, the EMA after each step, a
tail shorter than k as single steps) and `epoch_on_device` (the first
trained epoch staged on the device by data/device_cache.py, then every
epoch one pass over it with no host batch and no host sync until its end,
permuted per (seed, epoch) under `epoch_shuffle`; an epoch the cache
refuses trains through the staged loop, and so does the rest of the run).
`dispatches_total` counts the train dispatches (a step, k steps, an
epoch). The model and spatial axes of the mesh and the grad calibration
are not ported yet (ROADMAP A6).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..data import device_augment as daug
from ..models import build_model
from ..parallel import mesh
from ..parallel.prefetch import prefetch_to_device
from ..utils.device import pad_rows, resolve_device, to_device
from ..utils.faults import FaultInjector
from .checkpoint import CheckpointManager
from .config import TrainConfig
from .metrics import MetricsLogger
from .optim import build_optimizer
from .resilience import (GracefulShutdown, PreemptionExit, RetryPolicy,
                         StepWatchdog, log_resilience_event,
                         resilient_batches, stop_agreed)
from .schedules import PlateauState
from .steps import (draw_epoch_permutation, make_classification_eval_step,
                    make_classification_train_step, make_epoch_train_step,
                    make_multistep_train_step, step_and_ema)
from .train_state import TrainState, param_count

# The port's steps update the state in place and donate nothing; jaxlint's
# project-wide reach resolves `train_step` by name to the JAX package's
# donating step.
# jaxlint: disable-file=DON001


def say(message: str) -> None:
    """Print a run's line from rank 0 only."""
    if mesh.is_main_process():
        print(message, flush=True)


def _device_augments(config: TrainConfig, compute_dtype: torch.dtype):
    """The (train, eval) device augments of a classification config, its
    mean/std fitted to its channel count."""
    data = config.data
    kw = dict(mean=daug.channel_stats(data.mean, data.channels),
              std=daug.channel_stats(data.std, data.channels),
              compute_dtype=compute_dtype)
    return (daug.make_train_augment(data.image_size, **kw),
            daug.make_eval_augment(data.image_size, **kw))


def apply_pinned_model_kwargs(config: TrainConfig,
                              workdir: Optional[str]) -> TrainConfig:
    """`config` with the model kwargs a workdir pins in its
    `model_kwargs.json` folded over its own: a workdir holding imported
    or reduced weights names the architecture they fit, and every later
    run on it builds that one (the JAX package's
    `build_model_from_config(..., workdir=)`)."""
    pinned = os.path.join(workdir, "model_kwargs.json") if workdir else None
    if not pinned or not os.path.exists(pinned):
        return config
    with open(pinned) as fp:
        extra = json.load(fp)
    if not extra:
        return config
    say(f"[{config.name}] applying pinned model kwargs {extra}")
    return config.replace(model_kwargs={**config.model_kwargs, **extra})


class TrainingDivergedError(RuntimeError):
    """An epoch's mean train loss is non-finite: the optimizer state is
    poisoned, so training on would only waste card-hours."""


def divergence_halt(config: TrainConfig, ckpt: CheckpointManager, epoch: int,
                    what: str, resume_cmd: Optional[str] = None) -> None:
    """Raise TrainingDivergedError naming the checkpoint to resume from and
    the flag that does it (`-c <epoch>` unless `resume_cmd` says)."""
    last = ckpt.latest_epoch()
    resume = (f"resume from epoch {last} with `{resume_cmd or f'-c {last}'}`"
              if last is not None else "no checkpoint committed yet")
    raise TrainingDivergedError(
        f"[{config.name}] epoch {epoch} {what} — training diverged. "
        f"{resume}; consider a lower learning rate, warmup_epochs, or "
        f"grad_clip_norm. (Set halt_on_nonfinite=False to keep going anyway.)")


@contextlib.contextmanager
def epoch_profile(profile_dir: Optional[str], device: torch.device,
                  name: str):
    """A `torch.profiler` trace (host and, on the card, CUDA activity) of
    the block, written as `<profile_dir>/<name>.pt.trace.json` (a rank's
    `<name>.rank<r>.pt.trace.json` under a process group) when the block
    ends, however it ends; nothing when `profile_dir` is None (the
    JAX trainer's `jax.profiler` trace of the first epoch)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        rank = f".rank{mesh.rank()}" if mesh.world_size() > 1 else ""
        path = os.path.join(profile_dir, f"{name}{rank}.pt.trace.json")
        prof.export_chrome_trace(path)
        say(f"[{name}] profile of the first epoch: {path}")


def fit_and_close(trainer: "Trainer", *args, **kwargs) -> dict:
    """`trainer.fit(...)` then `close()`, with the entry point's divergence
    UX: a TrainingDivergedError becomes a one-line remedy and a nonzero
    exit instead of a traceback, and a PreemptionExit (SIGTERM or SIGINT
    seen, checkpoint committed) the resume hint and exit 0."""
    try:
        return trainer.fit(*args, **kwargs)
    except TrainingDivergedError as e:
        raise SystemExit(f"error: {e}")
    except PreemptionExit as e:
        say(str(e))
        raise SystemExit(0)
    finally:
        trainer.close()


class _StepClock:
    """Wall time of each step without a host sync per step: CUDA events on
    the card, read once at the end of the epoch; the host clock on the CPU,
    where every step runs synchronously."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self._done = 0
        self.mark()

    def progressed(self) -> bool:
        """Whether a mark recorded since the last call has completed on the
        device, found without blocking (`Event.query`); on the CPU every
        mark has."""
        done = self._done
        while self._done < len(self.marks) and (
                not self.cuda or self.marks[self._done].query()):
            self._done += 1
        return self._done > done

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> List[float]:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def check_dispatch_levers(config: TrainConfig) -> None:
    """The JAX trainer's refusals of the dispatch levers: each pair would
    desync the EMA and the accumulation cycle, or stack two levers over
    the same loop."""
    accum = config.optimizer.accum_steps
    if config.steps_per_dispatch > 1 and accum > 1:
        raise ValueError(
            "steps_per_dispatch > 1 is incompatible with accum_steps > 1 "
            "(the k-step dispatch would desync the EMA/accumulation "
            "cadence) — pick one lever")
    if config.epoch_on_device:
        if config.steps_per_dispatch > 1:
            raise ValueError(
                "epoch_on_device and steps_per_dispatch > 1 are both "
                "dispatch-amortization levers over the same loop — the "
                "epoch pass already runs every step in one dispatch; "
                "pick one")
        if accum > 1:
            raise ValueError(
                "epoch_on_device is incompatible with accum_steps > 1 "
                "(the epoch pass would desync the EMA/accumulation "
                "cadence, same as steps_per_dispatch)")


class Trainer:
    """`fit(train_data_fn, val_data_fn)` where each returns an epoch's
    iterable of numpy batch tuples, forwarded positionally to the family's
    train and eval steps: (images, labels) for classification."""

    # subclass override for the watched metric, e.g. ("loss", "min"); None
    # derives it from the plateau config (top-1 max by default)
    default_watch = None

    def __init__(self, config: TrainConfig, *, device=None,
                 workdir: Optional[str] = None,
                 model: Optional[torch.nn.Module] = None):
        self.device = resolve_device(device)
        self.workdir = workdir or config.checkpoint_dir
        if model is None:
            config = apply_pinned_model_kwargs(config, self.workdir)
            model = build_model(config)
        self.config = config
        self.model = model
        self.rank, self.world = mesh.rank(), mesh.world_size()
        mesh.check_batch_divisible(config.batch_size, self.world)
        if config.eval_batch_size:
            mesh.check_batch_divisible(config.eval_batch_size, self.world,
                                       what="eval_batch_size")
        self.steps_per_epoch = max(
            1, config.data.train_examples // config.batch_size)
        # one update sees batch_size * accum_steps examples: linear LR
        # scaling uses that effective batch
        opt_cfg = config.optimizer
        effective_batch = config.batch_size * opt_cfg.accum_steps
        if opt_cfg.accum_steps > 1:
            say(f"[{config.name}] gradient accumulation: "
                f"{opt_cfg.accum_steps} micro-steps -> effective batch "
                f"{effective_batch}")
        check_dispatch_levers(config)
        if (opt_cfg.base_batch_size
                and effective_batch != opt_cfg.base_batch_size):
            scaled = (opt_cfg.learning_rate * effective_batch
                      / opt_cfg.base_batch_size)
            say(f"[{config.name}] linear LR scaling: "
                f"{opt_cfg.learning_rate} -> {scaled:g} (batch "
                f"{effective_batch}/{opt_cfg.base_batch_size})")
            opt_cfg = dataclasses.replace(opt_cfg, learning_rate=scaled)
        self.opt_cfg = opt_cfg
        sched = config.schedule
        self.plateau = PlateauState(
            patience=sched.plateau_patience, factor=sched.plateau_factor,
            mode=sched.plateau_mode) if sched.name == "plateau" else None
        self.logger = MetricsLogger(self.workdir, name=config.name,
                                     device=self.device)
        # resilience: the environment's fault injector (inert unless a
        # DEEPVISION_FAULT_* variable is set) and the transient-I/O retry
        # policy of the checkpoint and the host data pull
        self.faults = FaultInjector.from_env()
        self.retry_policy = RetryPolicy.from_env()
        self._recovery_scale = 1.0   # product of the rollbacks' factors
        self._recoveries = 0
        self._host_step = 0
        self._last_saved_epoch: Optional[int] = None
        self._prefetcher = None      # the live prefetcher during an epoch
        self._watchdog: Optional[StepWatchdog] = None
        #: what the watchdog does on a stall; None is its exit (code 70)
        self.watchdog_abort: Optional[Callable[[], None]] = None
        self.state: Optional[TrainState] = None
        self.start_epoch = 1
        self.best_metric: Optional[float] = None
        #: per-step host metrics (with `step_ms`) of the last trained epoch
        self.last_epoch_steps: List[Dict[str, float]] = []
        #: the prefetcher's transfer ledger at the end of the last epoch
        self.last_prefetch_ledger: Dict[str, float] = {}
        self._shutdown: Optional[GracefulShutdown] = None
        #: obs.trace.Tracer once `arm_tracing` ran (`--trace-out`)
        self.tracer = None
        self._trace_out: Optional[str] = None
        # the dispatch levers: the k-step dispatch and the epoch pass,
        # built at first use (a family installs its train_step after this
        # __init__); the epoch cache, and the sticky fallback to the staged
        # loop once the cache refused an epoch
        self._multi_step = None
        self._epoch_step = None
        self._epoch_cache = None
        self._epoch_fallback = False
        #: train dispatches so far (a step, k steps or an epoch each count 1)
        self.dispatches_total = 0
        #: each dispatch of the last staged epoch: its steps, device ms
        #: (CUDA events) and the host's ms issuing it
        self.last_epoch_dispatches: List[Dict[str, float]] = []
        if self.default_watch is not None:
            self.watch_key, self.watch_mode = self.default_watch
        elif self.plateau and sched.plateau_mode == "min":
            self.watch_key, self.watch_mode = "loss", "min"
        else:
            self.watch_key, self.watch_mode = "top1", "max"
        self.ckpt = CheckpointManager(
            self.workdir + "/ckpt", keep=config.keep_checkpoints,
            keep_best=config.keep_best, best_mode=self.watch_mode,
            retry_policy=self.retry_policy, on_retry=self._log_retry,
            fault_injector=self.faults if self.faults.active else None)
        # the classification steps; a family subclass installs its own
        compute_dtype = getattr(torch, config.dtype)
        input_norm = ((config.data.mean, config.data.std)
                      if config.data.normalize_on_device else None)
        train_augment = eval_augment = None
        if config.device_augment:
            # the augment normalizes, so the steps' input_norm is off
            train_augment, eval_augment = _device_augments(config,
                                                           compute_dtype)
            input_norm = None
        self.train_step: Callable[..., Dict[str, torch.Tensor]] = \
            make_classification_train_step(
                label_smoothing=config.label_smoothing,
                aux_weight=config.aux_loss_weight,
                compute_dtype=compute_dtype, input_norm=input_norm,
                augment=train_augment, mixup_alpha=config.mixup_alpha,
                cutmix_alpha=config.cutmix_alpha,
                log_grad_norm=config.log_grad_norm)
        self.eval_step: Callable[..., Dict[str, torch.Tensor]] = \
            make_classification_eval_step(compute_dtype=compute_dtype,
                                          input_norm=input_norm,
                                          augment=eval_augment)

    # -- state ------------------------------------------------------------
    def init_state(self) -> TrainState:
        self.model.to(self.device)
        optimizer = build_optimizer(self.model.parameters(), self.opt_cfg,
                                    self.config.schedule,
                                    self.steps_per_epoch,
                                    self.config.total_epochs)
        self.state = TrainState(self.model, optimizer, seed=self.config.seed,
                                ema_decay=self.config.ema_decay,
                                remat=self.config.remat)
        world = (f" world={self.world} batch/rank="
                 f"{self.config.batch_size // self.world}"
                 if mesh.is_initialized() else "")
        say(f"[{self.config.name}] model={self.config.model} "
            f"params={param_count(self.model):,} device={self.device} "
            f"steps/epoch={self.steps_per_epoch}{world}")
        return self.state

    def _log_retry(self, what: str, attempt: int, exc: BaseException,
                   delay: float) -> None:
        """The retry hook of the checkpoint and the data pull: stderr on
        every rank, the metrics stream on rank 0. May fire from the
        prefetch and checkpoint threads (the logger locks)."""
        print(f"[{self.config.name}] transient {what} failure "
              f"(attempt {attempt}/{self.retry_policy.max_retries}): {exc} "
              f"— retrying in {delay:.2f}s", file=sys.stderr, flush=True)
        log_resilience_event(self.logger, self._host_step,
                             {f"{what}_retries": float(attempt)})

    def resume(self, epoch: Optional[int] = None,
               verify: Optional[str] = None) -> Optional[int]:
        """Restore the latest (or the given) checkpoint — the `-c` and
        `--auto-resume` UX. `verify` overrides `config.resume_verify`
        ("fallback", "strict" or "off"). Returns the restored epoch, or
        None when nothing is saved."""
        if self.state is None:
            raise RuntimeError("call init_state first")
        state, host, got = self.ckpt.restore(
            epoch, verify=verify if verify is not None
            else self.config.resume_verify)
        if got is None:
            return None
        self.state.load_state_dict(state)
        self._host_step = self.state.step
        self.start_epoch = got + 1
        self.best_metric = host.get("best_metric")
        if self.plateau and "plateau" in host:
            p = host["plateau"]
            self.plateau.best = p.get("best")
            self.plateau.num_bad_epochs = p.get("num_bad_epochs", 0)
            self.plateau.scale = p.get("scale", 1.0)
            self.state.optimizer.set_lr_scale(self.plateau.scale)
        info = self.ckpt.last_restore_info or {}
        if info.get("fallback_skipped") or not info.get("verified", False):
            # a corruption fallback or an unverified (legacy) restore
            log_resilience_event(
                self.logger, self._host_step,
                {"ckpt_fallback_generations":
                    float(info.get("fallback_skipped") or 0),
                 "ckpt_verified": 1.0 if info.get("verified") else 0.0})
        say(f"[{self.config.name}] resumed from epoch {got}")
        return got

    def _to_device(self, batch) -> tuple:
        return tuple(to_device(a, self.device) for a in batch)

    def _preempted(self) -> bool:
        """Whether a stop was requested, on any rank (every rank calls
        this at the same points and gets the same answer)."""
        return stop_agreed(self._shutdown)

    # -- loops ------------------------------------------------------------
    def run_step(self, batch: tuple) -> Dict[str, torch.Tensor]:
        """The train step on a batch already on the device, then the EMA
        update when the step applied an optimizer update (once per
        accumulation cycle under `accum_steps`)."""
        return step_and_ema(self.train_step, self.state, batch)

    def train_epoch(self, epoch: int, data: Iterable) -> dict:
        """One training epoch: the whole-epoch pass over the epoch cache
        under `config.epoch_on_device` (unless the cache refused an epoch
        of this run), else the staged loop."""
        if self.config.epoch_on_device and not self._epoch_fallback:
            return self._train_epoch_on_device(epoch, data)
        return self._train_epoch_staged(epoch, data)

    def _train_epoch_staged(self, epoch: int, data: Iterable,
                            wrapped: bool = False) -> dict:
        """The staged loop: host batches staged on the device by the
        prefetcher → dispatches of one step (or of k under
        `steps_per_dispatch`, a tail shorter than k as single steps), each
        step followed by its EMA update. The metrics stay on the device;
        a dispatch that crosses a `log_every_steps` boundary is logged
        (the mean of its steps), and everything is read once at the end.
        Returns the epoch's mean metrics (of the global batches),
        `images_per_sec` of the whole job over the whole epoch (and, under
        a process group, `images_per_sec_rank`) and `step_ms`, the median
        step time after the first dispatch (which also pays for the first
        use of every kernel). `wrapped`: `data` already went through
        `resilient_batches` (the epoch cache's fallback stream)."""
        t0 = time.time()
        log_every = self.config.log_every_steps
        k = self.config.steps_per_dispatch
        device_metrics: List[Dict[str, torch.Tensor]] = []
        sizes: List[int] = []            # steps of each dispatch
        host_ms: List[float] = []        # host time issuing each dispatch
        n_img = 0
        clock = _StepClock(self.device)
        state = self.state
        if not wrapped:
            data = resilient_batches(
                data, self.retry_policy,
                injector=self.faults if self.faults.active else None,
                on_retry=self._log_retry)
        staged = prefetch_to_device(data, self.config.prefetch_batches,
                                    self.device)
        self._prefetcher = staged
        self._beat()
        # tracing accumulators (arm_tracing): [host data-wait ns, dispatch
        # ns, window start ns, steps at the window's start]; None keeps the
        # untraced loop at one branch per step
        tacc = ([0, 0, time.monotonic_ns(), 0]
                if self.tracer is not None else None)
        steps = 0

        def run(dispatch: list) -> None:
            nonlocal steps, n_img
            prev = state.step
            t_d = time.monotonic_ns()
            if len(dispatch) == 1:
                per_step = [self.run_step(dispatch[0])]
                logged = per_step[0]
            else:
                if self._multi_step is None:
                    self._multi_step = make_multistep_train_step(
                        self.train_step, k)
                per_step, logged = self._multi_step(state, dispatch)
            dt_ns = time.monotonic_ns() - t_d
            host_ms.append(dt_ns / 1e6)
            if tacc:
                tacc[1] += dt_ns
            clock.mark()
            self.dispatches_total += 1
            steps += len(per_step)
            sizes.append(len(per_step))
            self._host_step = state.step
            if self._watchdog is not None and clock.progressed():
                self._watchdog.beat()
            device_metrics.extend(per_step)
            n_img += sum(len(b[0]) for b in dispatch)
            if state.step // log_every > prev // log_every:
                self.logger.log(state.step, logged, prefix="train_",
                                epoch=epoch)
                if tacc:
                    self._emit_window_spans(tacc, epoch, steps)

        group: list = []
        try:
            batches = iter(staged)
            while True:
                t_wait = time.monotonic_ns() if tacc else 0
                batch = next(batches, None)
                if batch is None:
                    break
                if self._preempted():
                    break  # the last step has finished; fit() saves
                if tacc:
                    tacc[0] += time.monotonic_ns() - t_wait
                if k > 1:
                    group.append(batch)
                    if len(group) == k:
                        dispatch, group = group, []
                        run(dispatch)
                else:
                    run([batch])
            if not self._preempted():
                for batch in group:      # the tail shorter than k
                    run([batch])
            group = []
            if tacc and steps > tacc[3]:
                self._emit_window_spans(tacc, epoch, steps)
        finally:
            # a failing step must not pin staged batches in a traceback
            group = None
            self._prefetcher = None
            self.last_prefetch_ledger = staged.ledger()
            staged.close()
        dispatch_ms = clock.step_ms() if device_metrics else []
        self.last_epoch_dispatches = [
            {"steps": float(n), "ms": ms, "host_ms": h}
            for n, ms, h in zip(sizes, dispatch_ms, host_ms)]
        step_ms = [ms / n for n, ms in zip(sizes, dispatch_ms)
                   for _ in range(n)]
        out = self._epoch_metrics(device_metrics, step_ms,
                                  skip=sizes[0] if sizes else 0)
        dt = time.time() - t0
        out["images_per_sec"] = n_img * self.world / dt if dt > 0 else 0.0
        if mesh.is_initialized():
            out["images_per_sec_rank"] = n_img / dt if dt > 0 else 0.0
        self._halt_if_nonfinite(out, epoch)
        return out

    def _train_epoch_on_device(self, epoch: int, data: Iterable) -> dict:
        """The whole epoch from the device: the first call stages the
        epoch's batches on the device once (data/device_cache.py), and
        every epoch is one pass over them (`make_epoch_train_step`),
        permuted per (seed, epoch) under `config.epoch_shuffle`, with no
        host batch and no host sync until the end, where the per-step
        metrics are read at once and the epoch is logged. An epoch the
        cache refuses (its budget, a ragged or empty stream; a named
        EpochCacheOverflowWarning) trains through the staged loop, and so
        does the rest of the run."""
        from ..data import device_cache
        cfg = self.config
        if self._epoch_cache is None:
            src = resilient_batches(
                data, self.retry_policy,
                injector=self.faults if self.faults.active else None,
                on_retry=self._log_retry)
            cache, fallback = device_cache.build_epoch_cache(
                src, self.device, shuffle=cfg.epoch_shuffle, name=cfg.name)
            if cache is None:
                self._epoch_fallback = True
                return self._train_epoch_staged(epoch, fallback,
                                                wrapped=True)
            self._epoch_cache = cache
            say(f"[{cfg.name}] epoch cache: {cache.steps} steps x "
                f"{cache.examples_per_step} examples on the device "
                f"({cache.nbytes / 1e6:.1f} MB staged once in "
                f"{cache.stage_secs:.2f}s), one pass an epoch"
                + (", shuffled per (seed, epoch)" if cfg.epoch_shuffle
                   else ""))
        cache = self._epoch_cache
        if self._epoch_step is None:
            self._epoch_step = make_epoch_train_step(self.train_step)
        t0 = time.time()
        state = self.state
        clock = _StepClock(self.device)
        perm = (draw_epoch_permutation(
            cfg.seed, epoch, cache.steps * cache.examples_per_step,
            self.device) if cfg.epoch_shuffle else None)

        def on_step() -> None:
            clock.mark()
            self._host_step = state.step
            if self._watchdog is not None and clock.progressed():
                self._watchdog.beat()

        self._beat()
        t_d = time.monotonic_ns()
        per_step = self._epoch_step(state, cache.arrays, perm, on_step)
        dispatch_ns = time.monotonic_ns() - t_d
        self.dispatches_total += 1
        out = self._epoch_metrics(per_step, clock.step_ms(), skip=1)
        self._beat()
        dt = time.time() - t0
        n_img = cache.steps * cache.examples_per_step
        out["images_per_sec"] = n_img * self.world / dt if dt > 0 else 0.0
        if mesh.is_initialized():
            out["images_per_sec_rank"] = n_img / dt if dt > 0 else 0.0
        if self.tracer is not None:
            wid = self.tracer.add(
                "train_window", "train", t_d, dispatch_ns,
                args={"epoch": epoch, "steps": cache.steps})
            self.tracer.add("train_dispatch", "train", t_d, dispatch_ns,
                            args={"window": wid, "aggregate": True})
        self.logger.log(state.step, {k: v for k, v in out.items()
                                     if k not in ("images_per_sec",
                                                  "images_per_sec_rank")},
                        prefix="train_", epoch=epoch)
        self._halt_if_nonfinite(out, epoch)
        return out

    def _epoch_metrics(self, device_metrics: List[Dict[str, torch.Tensor]],
                       step_ms: List[float], skip: int) -> Dict[str, float]:
        """The steps' metrics read back at once: `last_epoch_steps` (each
        step's, with its `step_ms`) and the epoch's means, with `step_ms`
        the median after the first `skip` steps."""
        self.last_epoch_steps = []
        if not device_metrics:
            return {}
        keys = list(device_metrics[0])
        stacked = torch.stack([torch.stack([m[k].float() for k in keys])
                               for m in device_metrics]).cpu()
        self._beat()
        self.last_epoch_steps = [
            {**dict(zip(keys, row.tolist())), "step_ms": ms}
            for row, ms in zip(stacked, step_ms)]
        out = dict(zip(keys, stacked.mean(dim=0).tolist()))
        if len(step_ms) > skip:
            out["step_ms"] = statistics.median(step_ms[skip:])
        return out

    def _halt_if_nonfinite(self, out: dict, epoch: int) -> None:
        if self.config.halt_on_nonfinite and not math.isfinite(
                out.get("loss", 0.0)):
            self.logger.log(self.state.step, out, prefix="epoch_train_",
                            epoch=epoch)
            divergence_halt(self.config, self.ckpt, epoch,
                            f"mean train loss is {out['loss']}")

    def evaluate(self, data: Iterable) -> dict:
        """The family's evaluation (`_evaluate`) with the EMA parameters
        swapped in when the state keeps them, as the JAX package's
        `eval_state` does (the BatchNorm statistics stay the current
        ones)."""
        with self.state.ema_weights():
            return self._evaluate(data)

    def _evaluate(self, data: Iterable) -> dict:
        """Masked evaluation of global batches: a partial batch is
        zero-padded up to the largest batch seen so far in this pass,
        rounded up to a multiple of the world size (a running maximum, so
        the usual full-then-partial stream keeps one shape), its padded
        rows carrying mask 0; each rank evaluates its rows. Returns the
        metric sums (all-reduced) over `count`, with `count`; {} when
        nothing was evaluated."""
        sums: Dict[str, torch.Tensor] = {}
        target = 0
        for images, labels in data:
            n = len(labels)
            target = max(target, mesh.pad_to_multiple(n, self.world))
            mask = np.zeros((target,), np.float32)
            mask[:n] = 1.0
            if target != n:
                images, labels = (pad_rows(a, target)
                                  for a in (images, labels))
            rows = (mesh.shard_rows(a, self.rank, self.world)
                    for a in (images, labels, mask))
            m = self.eval_step(self.state, *self._to_device(rows))
            for k, v in m.items():     # summed in f64, read once at the end
                sums[k] = sums[k] + v.double() if k in sums else v.double()
        if sums and mesh.is_initialized():
            keys = list(sums)
            sums = dict(zip(keys, mesh.all_reduce_(
                torch.stack([sums[k] for k in keys]))))
        host = {k: float(v) for k, v in sums.items()}
        count = host.pop("count", 0.0)
        if count == 0:
            return {}
        out = {k: v / count for k, v in host.items()}
        out["count"] = count
        return out

    def fit(self, train_data_fn: Callable[[int], Iterable],
            val_data_fn: Optional[Callable[[int], Iterable]] = None,
            resume: bool = False,
            total_epochs: Optional[int] = None,
            profile_dir: Optional[str] = None) -> dict:
        """Per epoch: train, evaluate, watch the metric, step the plateau,
        save. A non-finite epoch rolls back and retries under
        `config.recover_on_divergence`; SIGTERM/SIGINT finish the step in
        flight, commit the epoch and raise PreemptionExit. Ends with the
        last save committed (`flush()`). `profile_dir` takes a
        `torch.profiler` trace of the first trained epoch there
        (`epoch_profile`), also when that epoch fails."""
        cfg = self.config
        total_epochs = total_epochs or cfg.total_epochs
        if self.state is None:
            self.init_state()
        if resume:
            self.resume()
        if self.state.ema is not None and cfg.ema_decay is None:
            # restored from an EMA-trained checkpoint, but this run would
            # re-save a frozen average: drop it, loudly
            say(f"[{cfg.name}] checkpoint carries EMA weights but "
                f"ema_decay is unset: discarding them for this training "
                f"run (pass --ema-decay to keep updating the average)")
            self.state.ema = None
        last_val: dict = {}
        recoveries_left = cfg.recover_on_divergence
        with contextlib.ExitStack() as stack:
            if cfg.graceful_shutdown:
                self._shutdown = stack.enter_context(GracefulShutdown(
                    what="finishing the step, saving a checkpoint, then "
                         "exiting 0"))
            if cfg.watchdog_secs:
                self._watchdog = stack.enter_context(StepWatchdog(
                    cfg.watchdog_secs, diagnostics=self._watchdog_diagnostics,
                    name=cfg.name, _abort=self.watchdog_abort))
            stack.callback(self._clear_resilience_handles)
            epoch = first_epoch = self.start_epoch
            while epoch <= total_epochs:
                if self._preempted() and self._last_saved_epoch is not None:
                    # the signal landed between epochs: the last save
                    # already holds everything trained
                    self._commit_preemption(self._last_saved_epoch)
                try:
                    with epoch_profile(profile_dir if epoch == first_epoch
                                       else None, self.device, cfg.name):
                        train_metrics = self.train_epoch(
                            epoch, train_data_fn(epoch))
                except TrainingDivergedError:
                    # bounded recovery: roll back to the last committed
                    # epoch, scale the LR down, retry; the halt fires once
                    # the budget is spent or nothing is committed
                    if recoveries_left <= 0:
                        raise
                    rolled = self._recover_from_divergence(epoch)
                    if rolled is None:
                        raise
                    recoveries_left -= 1
                    epoch = rolled + 1
                    continue
                self.logger.log(self.state.step, train_metrics,
                                prefix="epoch_train_", epoch=epoch)
                if self._preempted():
                    # preempted mid-epoch: skip the evaluation and commit
                    # what was trained as this epoch
                    self._save_epoch(epoch, metric=None)
                    self._commit_preemption(epoch)
                if val_data_fn is not None:
                    last_val = self.evaluate(val_data_fn(epoch))
                    self.logger.log(self.state.step, last_val,
                                    prefix="val_", epoch=epoch)
                    # an empty eval must not count as a perfect 0.0 loss in
                    # min mode
                    metric = last_val.get(
                        self.watch_key, 0.0 if self.watch_mode == "max"
                        else math.inf)
                else:
                    metric = train_metrics.get(
                        self.watch_key, 0.0 if self.watch_mode == "max"
                        else math.inf)
                if self.best_metric is None or (
                        metric > self.best_metric
                        if self.watch_mode == "max"
                        else metric < self.best_metric):
                    self.best_metric = metric
                if self.plateau:
                    self.state.optimizer.set_lr_scale(
                        self.plateau.update(metric) * self._recovery_scale)
                self._save_epoch(epoch, metric=metric)
                epoch += 1
        # fit returning means "training done": the last save is committed
        self.ckpt.flush()
        return {"best_metric": self.best_metric, **last_val}

    def _beat(self) -> None:
        if self._watchdog is not None:
            self._watchdog.beat()

    def _clear_resilience_handles(self) -> None:
        self._shutdown = None
        self._watchdog = None

    def _watchdog_diagnostics(self) -> dict:
        pf = self._prefetcher
        return {"last_step": self._host_step,
                "last_checkpoint_epoch": self._last_saved_epoch,
                "prefetch_queue_depth": (pf.queue_depth if pf is not None
                                         else None)}

    def _save_epoch(self, epoch: int, metric: Optional[float]) -> None:
        host = {"best_metric": self.best_metric}
        if self.plateau:
            host["plateau"] = {"best": self.plateau.best,
                               "num_bad_epochs": self.plateau.num_bad_epochs,
                               "scale": self.plateau.scale}
        t_ck = time.monotonic_ns() if self.tracer is not None else 0
        self.ckpt.save(epoch, self.state.state_dict(), host_state=host,
                       metric=metric)
        if self.tracer is not None:
            # the host-blocking share of the commit (the snapshot and the
            # enqueue; the writer thread does the rest)
            self.tracer.add("ckpt_commit", "train", t_ck,
                            time.monotonic_ns() - t_ck,
                            args={"epoch": epoch})
        self._last_saved_epoch = epoch

    def arm_tracing(self, trace_out: Optional[str] = None, tracer=None):
        """Arm span tracing (`--trace-out`): each log_every window of a
        training epoch emits a `train_window` span split into aggregate
        `host_data_wait` (time blocked on the prefetcher) and
        `train_dispatch` (host time in the step calls, which return before
        the card finishes) child spans, tagged with the prefetcher's
        transfer ledger; each checkpoint save emits a `ckpt_commit` span.
        The Chrome trace JSON is written to `trace_out` when the trainer
        closes. Returns the tracer (tests read it live)."""
        from ..obs.trace import Tracer
        # no sampling for training: windows come at the log_every rate
        self.tracer = tracer if tracer is not None else Tracer(sample=1.0)
        self._trace_out = trace_out
        return self.tracer

    def _emit_window_spans(self, tacc: list, epoch: int, steps: int) -> None:
        """One window's spans (the wall window and its aggregate data-wait
        and dispatch shares); resets the accumulators."""
        now_ns = time.monotonic_ns()
        w0 = tacc[2]
        pf = self._prefetcher
        ledger = ({"prefetch_queue_depth": pf.queue_depth,
                   "prefetch_bytes_staged": float(pf.bytes_staged_total),
                   "prefetch_stage_ms": round(pf.last_stage_secs * 1e3, 3)}
                  if pf is not None else {"prefetch_queue_depth": 0})
        wid = self.tracer.add(
            "train_window", "train", w0, now_ns - w0,
            args={"epoch": epoch, "steps": steps - tacc[3], **ledger})
        self.tracer.add("host_data_wait", "train", w0, tacc[0],
                        args={"window": wid, "aggregate": True})
        self.tracer.add("train_dispatch", "train", w0, tacc[1],
                        args={"window": wid, "aggregate": True})
        tacc[0] = tacc[1] = 0
        tacc[2] = now_ns
        tacc[3] = steps

    def _commit_preemption(self, epoch: int) -> None:
        """The graceful preemption tail: wait until the checkpoint of
        `epoch` is committed (a SIGKILL that follows must find it
        restorable), then raise PreemptionExit."""
        self.ckpt.flush()
        log_resilience_event(self.logger, self._host_step,
                             {"preempted_at_epoch": float(epoch)},
                             epoch=epoch)
        raise PreemptionExit(
            epoch,
            f"[{self.config.name}] graceful preemption: checkpoint "
            f"committed at epoch {epoch} — relaunch with --auto-resume "
            f"(or -c latest) to continue")

    def _recover_from_divergence(self, epoch: int) -> Optional[int]:
        """Roll back to the last committed checkpoint and scale the LR by
        `config.recovery_lr_factor` (the scale persists for the rest of the
        run and composes with the plateau's). Returns the restored epoch,
        or None when nothing is committed yet."""
        if self.ckpt.latest_epoch() is None:
            return None
        got = self.resume()
        if got is None:
            return None
        self._recoveries += 1
        self._recovery_scale *= self.config.recovery_lr_factor
        base = self.plateau.scale if self.plateau else 1.0
        self.state.optimizer.set_lr_scale(base * self._recovery_scale)
        say(f"[{self.config.name}] divergence recovery {self._recoveries}: "
            f"epoch {epoch} diverged — rolled back to epoch {got}, LR scale "
            f"now {self._recovery_scale:g}")
        log_resilience_event(
            self.logger, self._host_step,
            {"divergence_recoveries": float(self._recoveries),
             "lr_scale": self._recovery_scale}, epoch=epoch)
        return got

    def close(self) -> None:
        if self.tracer is not None and self._trace_out:
            from ..obs.export import write_chrome_trace
            path, self._trace_out = self._trace_out, None  # idempotent
            n = write_chrome_trace(self.tracer, path)
            say(f"[{self.config.name}] wrote {n} trace span(s) to {path} "
                f"(open in https://ui.perfetto.dev)")
        try:
            self.ckpt.close()
        finally:
            self.logger.close()


class LossWatchedTrainer(Trainer):
    """Base for the families that validate on loss only: watches ("loss",
    "min") for the best checkpoint and the plateau, and averages the finite
    per-batch validation losses."""

    default_watch = ("loss", "min")

    def __init__(self, config: TrainConfig, *args, **kwargs):
        if config.mixup_alpha or config.cutmix_alpha:
            # the family's steps never see mixup or CutMix: an error beats
            # a silent no-op
            raise ValueError(
                "mixup_alpha/cutmix_alpha are classification-only; the "
                f"{type(self).__name__} ignores them — use the task's own "
                "augmentations (flip/crop in the data pipeline) instead")
        if config.device_augment:
            # the family's steps never call the augment: they would train
            # on the raw padded uint8
            raise ValueError(
                f"device_augment is classification-only; the "
                f"{type(self).__name__} steps don't fuse it")
        super().__init__(config, *args, **kwargs)

    def _evaluate(self, data: Iterable) -> dict:
        """Each rank evaluates its rows of every global batch; a batch
        counts when the global batch's loss is finite, which every rank
        reads alike."""
        total, n = 0.0, 0
        for batch in data:
            rows = (mesh.shard_rows(a, self.rank, self.world) for a in batch)
            m = self.eval_step(self.state, *self._to_device(rows))
            loss = float(mesh.global_means(m)["loss"])
            if math.isfinite(loss):
                total += loss
                n += 1
        return {"loss": total / n, "count": float(n)} if n else {}
