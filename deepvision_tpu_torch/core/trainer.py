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
and writes the checkpoints; the others wait for each save at a barrier,
and all of them resume. The model and spatial axes, grad calibration, the
epoch cache, multi-step dispatch, tracing, the watchdog, fault injection
and divergence recovery are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..data import device_augment as daug
from ..models import build_model
from ..parallel import mesh
from ..parallel.prefetch import prefetch_to_device
from ..utils.device import resolve_device
from .checkpoint import CheckpointManager
from .config import TrainConfig
from .metrics import MetricsLogger
from .optim import build_optimizer
from .resilience import GracefulShutdown, stop_agreed
from .schedules import PlateauState
from .steps import (make_classification_eval_step,
                    make_classification_train_step)
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


def fit_and_close(trainer: "Trainer", *args, **kwargs) -> dict:
    """`trainer.fit(...)` then `close()`, with the entry point's divergence
    UX: a TrainingDivergedError becomes a one-line remedy and a nonzero
    exit instead of a traceback."""
    try:
        return trainer.fit(*args, **kwargs)
    except TrainingDivergedError as e:
        raise SystemExit(f"error: {e}")
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
        self.mark()

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
        self.logger = MetricsLogger(self.workdir, name=config.name)
        self.state: Optional[TrainState] = None
        self.start_epoch = 1
        self.best_metric: Optional[float] = None
        #: per-step host metrics (with `step_ms`) of the last trained epoch
        self.last_epoch_steps: List[Dict[str, float]] = []
        #: the prefetcher's transfer ledger at the end of the last epoch
        self.last_prefetch_ledger: Dict[str, float] = {}
        self._shutdown: Optional[GracefulShutdown] = None
        if self.default_watch is not None:
            self.watch_key, self.watch_mode = self.default_watch
        elif self.plateau and sched.plateau_mode == "min":
            self.watch_key, self.watch_mode = "loss", "min"
        else:
            self.watch_key, self.watch_mode = "top1", "max"
        self.ckpt = CheckpointManager(
            self.workdir + "/ckpt", keep=config.keep_checkpoints,
            keep_best=config.keep_best, best_mode=self.watch_mode)
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
                augment=train_augment)
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
                                ema_decay=self.config.ema_decay)
        world = (f" world={self.world} batch/rank="
                 f"{self.config.batch_size // self.world}"
                 if mesh.is_initialized() else "")
        say(f"[{self.config.name}] model={self.config.model} "
            f"params={param_count(self.model):,} device={self.device} "
            f"steps/epoch={self.steps_per_epoch}{world}")
        return self.state

    def resume(self, epoch: Optional[int] = None) -> Optional[int]:
        """Restore the latest (or the given) checkpoint — the `-c` UX.
        Returns the restored epoch, or None when nothing is saved."""
        if self.state is None:
            raise RuntimeError("call init_state first")
        restored = self.ckpt.restore(epoch)
        if restored is None:
            return None
        got, payload = restored
        self.state.load_state_dict(payload["state"])
        host = payload["host"]
        self.start_epoch = got + 1
        self.best_metric = host.get("best_metric")
        if self.plateau and "plateau" in host:
            p = host["plateau"]
            self.plateau.best = p.get("best")
            self.plateau.num_bad_epochs = p.get("num_bad_epochs", 0)
            self.plateau.scale = p.get("scale", 1.0)
            self.state.optimizer.set_lr_scale(self.plateau.scale)
        say(f"[{self.config.name}] resumed from epoch {got}")
        return got

    def _to_device(self, batch) -> tuple:
        return tuple(torch.as_tensor(np.asarray(a)).to(self.device,
                                                       non_blocking=True)
                     for a in batch)

    def _preempted(self) -> bool:
        """Whether a stop was requested, on any rank (every rank calls
        this at the same points and gets the same answer)."""
        return stop_agreed(self._shutdown)

    # -- loops ------------------------------------------------------------
    def run_step(self, batch: tuple) -> Dict[str, torch.Tensor]:
        """The train step on a batch already on the device, then the EMA
        update when the step applied an optimizer update (once per
        accumulation cycle under `accum_steps`)."""
        state = self.state
        applied = state.optimizer.count
        metrics = self.train_step(state, *batch)
        if state.ema is not None and state.optimizer.count != applied:
            with torch.profiler.record_function("ema_update"):
                state.update_ema()
        return metrics

    def train_epoch(self, epoch: int, data: Iterable) -> dict:
        """The staged per-batch loop: host batches staged on the device by
        the prefetcher → step → EMA. Returns the epoch's mean metrics (of
        the global batches), `images_per_sec` of the whole job over the
        whole epoch (and, under a process group, `images_per_sec_rank`)
        and `step_ms`, the median step time after the first (which also
        pays for the first use of every kernel)."""
        t0 = time.time()
        log_every = self.config.log_every_steps
        device_metrics: List[Dict[str, torch.Tensor]] = []
        n_img = 0
        clock = _StepClock(self.device)
        state = self.state
        staged = prefetch_to_device(data, self.config.prefetch_batches,
                                    self.device)
        try:
            for batch in staged:
                if self._preempted():
                    break  # the last step has finished; fit() saves
                metrics = self.run_step(batch)
                clock.mark()
                device_metrics.append(metrics)
                n_img += len(batch[0])
                if state.step % log_every == 0:
                    self.logger.log(state.step, metrics, prefix="train_",
                                    epoch=epoch)
        finally:
            self.last_prefetch_ledger = staged.ledger()
            staged.close()
        out: Dict[str, float] = {}
        self.last_epoch_steps = []
        if device_metrics:
            keys = list(device_metrics[0])
            stacked = torch.stack([torch.stack([m[k].float() for k in keys])
                                   for m in device_metrics]).cpu()
            step_ms = clock.step_ms()
            self.last_epoch_steps = [
                {**dict(zip(keys, row.tolist())), "step_ms": ms}
                for row, ms in zip(stacked, step_ms)]
            out = dict(zip(keys, stacked.mean(dim=0).tolist()))
            if len(step_ms) > 1:
                out["step_ms"] = statistics.median(step_ms[1:])
        dt = time.time() - t0
        out["images_per_sec"] = n_img * self.world / dt if dt > 0 else 0.0
        if mesh.is_initialized():
            out["images_per_sec_rank"] = n_img / dt if dt > 0 else 0.0
        if self.config.halt_on_nonfinite and not math.isfinite(
                out.get("loss", 0.0)):
            self.logger.log(self.state.step, out, prefix="epoch_train_",
                            epoch=epoch)
            divergence_halt(self.config, self.ckpt, epoch,
                            f"mean train loss is {out['loss']}")
        return out

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
                pad = [(0, target - n)]
                images = np.pad(np.asarray(images),
                                pad + [(0, 0)] * (np.ndim(images) - 1))
                labels = np.pad(np.asarray(labels), pad)
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
            total_epochs: Optional[int] = None) -> dict:
        """Per epoch: train, evaluate, watch the metric, step the plateau,
        save. SIGTERM/SIGINT finish the step in flight, save the epoch and
        return with `preempted_at_epoch` set."""
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
        result: dict = {}
        with GracefulShutdown(what="finishing the step, saving a "
                                   "checkpoint, then exiting 0") as shutdown:
            self._shutdown = shutdown
            try:
                for epoch in range(self.start_epoch, total_epochs + 1):
                    train_metrics = self.train_epoch(epoch,
                                                     train_data_fn(epoch))
                    self.logger.log(self.state.step, train_metrics,
                                    prefix="epoch_train_", epoch=epoch)
                    if self._preempted():
                        self._save_epoch(epoch, metric=None)
                        say(f"[{cfg.name}] graceful preemption: checkpoint "
                            f"committed at epoch {epoch} — relaunch with "
                            f"-c latest to continue")
                        result["preempted_at_epoch"] = epoch
                        break
                    if val_data_fn is not None:
                        last_val = self.evaluate(val_data_fn(epoch))
                        self.logger.log(self.state.step, last_val,
                                        prefix="val_", epoch=epoch)
                        # an empty eval must not count as a perfect 0.0
                        # loss in min mode
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
                            self.plateau.update(metric))
                    self._save_epoch(epoch, metric=metric)
            finally:
                self._shutdown = None
        return {"best_metric": self.best_metric, **last_val, **result}

    def _save_epoch(self, epoch: int, metric: Optional[float]) -> None:
        host = {"best_metric": self.best_metric}
        if self.plateau:
            host["plateau"] = {"best": self.plateau.best,
                               "num_bad_epochs": self.plateau.num_bad_epochs,
                               "scale": self.plateau.scale}
        self.ckpt.save(epoch, {"state": self.state.state_dict(),
                               "host": host}, metric=metric)

    def close(self) -> None:
        self.logger.close()


class LossWatchedTrainer(Trainer):
    """Base for the families that validate on loss only: watches ("loss",
    "min") for the best checkpoint and the plateau, and averages the finite
    per-batch validation losses."""

    default_watch = ("loss", "min")

    def __init__(self, config: TrainConfig, *args, **kwargs):
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
