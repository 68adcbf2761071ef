"""Adversarial (DCGAN, CycleGAN) steps and trainers (own copy of
deepvision_tpu/core/gan.py: `_bce_logits`, `_mse`, `_mae`,
`AdversarialTrainer`, `make_dcgan_train_step`, `DCGANTrainer`,
`make_cyclegan_generator_step`, `make_cyclegan_discriminator_step`,
`CycleGANTrainer`).

- DCGAN (`DCGAN/tensorflow/main.py:20-88`): one step, two Adam
  optimizers; the generator's and the discriminator's gradients are both
  taken against the pre-update parameters, then both applied. The
  generator's BatchNorm statistics advance once, in its own train-mode
  forward; the discriminator sees the fakes detached.
- CycleGAN (`CycleGAN/tensorflow/train.py:150-344`): a generator phase
  (one loss over both generators: GAN + 10 cycle + 5 identity, one
  optimizer over both), the host `ImagePool`s on the fakes, then a
  discriminator phase (each (real + fake) / 2 LSGAN, one optimizer over
  both). The discriminators run in train mode inside the generator phase,
  so their BatchNorm statistics advance there and carry into the
  discriminator phase; the generators' advance six times a step. Train
  mode BatchNorm updates its running statistics at each forward, so the
  steps call the networks in the JAX package's order.

A pair of networks is one `TrainState` over a `ModuleDict` ({"a2b",
"b2a"} generators, {"a", "b"} discriminators): one optimizer over both,
the reference's concatenated variables. The noise and the dropout masks
come from the states' (seed, step) generators, on streams of their own;
the DCGAN step also takes its noise as an argument. A checkpoint is {"gen", "disc"},
saved every 2 epochs and at the last, the last `keep_checkpoints` kept.

The port runs these trainers in one process and refuses a process group
of more than one rank (GANs under torchrun are ROADMAP A6). They share the
supervised trainer's resilience (deepvision_tpu/core/gan.py): the fault
injector and the retry policy from the environment, the host pull under
`resilient_batches`, SIGTERM/SIGINT committing a checkpoint and raising
PreemptionExit, and bounded divergence recovery: a non-finite epoch rolls
both networks and both optimizers back to the last {gen, disc}
checkpoint, multiplies both LR scales by `recovery_lr_factor`, and
retries.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.gan import (CycleGANGenerator, DCGANDiscriminator,
                          DCGANGenerator, PatchGANDiscriminator)
from ..parallel import mesh
from ..utils.device import resolve_device, to_device
from ..utils.faults import FaultInjector
from ..utils.image_pool import ImagePool
from .checkpoint import CheckpointManager
from .config import TrainConfig
from .metrics import MetricsLogger
from .optim import build_optimizer
from .resilience import (GracefulShutdown, PreemptionExit, RetryPolicy,
                         log_resilience_event, resilient_batches)
from .steps import annotate_step
from .train_state import TrainState
from .trainer import _StepClock, divergence_halt, say

LAMBDA_CYCLE = 10.0  # `CycleGAN/tensorflow/train.py:16-17`
LAMBDA_ID = 5.0

Metrics = Dict[str, torch.Tensor]


def _bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """BinaryCrossentropy(from_logits=True) against all-`target` labels."""
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target))


def _mse(pred: torch.Tensor, target: float) -> torch.Tensor:
    """LSGAN loss (`CycleGAN/tensorflow/train.py:58-63`)."""
    return (pred - target).square().mean()


def _mae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cycle and identity loss (`train.py:65-72`)."""
    return (a - b).abs().mean()


def _apply(state: TrainState, loss: torch.Tensor) -> None:
    """One optimizer update of `state` on the gradient of `loss` with
    respect to its model's parameters alone."""
    params = state.optimizer.params
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    state.optimizer.step()
    state.step += 1


def _state(model: torch.nn.Module, config: TrainConfig,
           steps_per_epoch: int, device: torch.device) -> TrainState:
    model.to(device)
    return TrainState(model, build_optimizer(
        model.parameters(), config.optimizer, config.schedule,
        steps_per_epoch, config.total_epochs), seed=config.seed)


class AdversarialTrainer:
    """The epoch loop of the two-network trainers: per-step metrics kept on
    the device and averaged at the end of the epoch, a {gen, disc}
    checkpoint every `save_every` epochs and at the last, resume, graceful
    preemption and divergence recovery. Subclasses set `gen_state` /
    `disc_state` and implement `train_batch(*batch) -> metrics`."""

    gen_state: TrainState
    disc_state: TrainState

    def _init_common(self, config: TrainConfig, workdir: str,
                     device) -> None:
        if config.steps_per_dispatch > 1:
            # an error beats silently dispatching one step at a time
            raise ValueError(
                "steps_per_dispatch > 1 is not supported by adversarial "
                "trainers: the CycleGAN step round-trips through the host "
                "ImagePool between its two phases, and DCGAN keeps one "
                "dispatch per step for the same two-optimizer shape")
        if mesh.world_size() > 1:
            raise ValueError(
                f"{type(self).__name__} runs in one process in the port: "
                f"data-parallel GANs under torchrun are not ported yet "
                f"(ROADMAP A6); got a process group of "
                f"{mesh.world_size()} ranks")
        self.config = config
        self.device = resolve_device(device)
        self.workdir = workdir
        self.logger = MetricsLogger(workdir, name=config.name,
                                     device=self.device)
        self.faults = FaultInjector.from_env()
        self.retry_policy = RetryPolicy.from_env()
        self._recovery_scale = 1.0
        self._recoveries = 0
        self._batch_count = 0
        self._shutdown: Optional[GracefulShutdown] = None
        self.ckpt = CheckpointManager(
            workdir + "/ckpt", keep=config.keep_checkpoints, keep_best=False,
            retry_policy=self.retry_policy, on_retry=self._log_retry,
            fault_injector=self.faults if self.faults.active else None)
        self.start_epoch = 1
        #: per-step host metrics (with `step_ms`) of the last trained epoch
        self.last_epoch_steps: List[Dict[str, float]] = []

    def _stage(self, *arrays) -> Tuple[torch.Tensor, ...]:
        return tuple(to_device(a, self.device) for a in arrays)

    def _payload(self) -> dict:
        return {"gen": self.gen_state.state_dict(),
                "disc": self.disc_state.state_dict()}

    def _log_retry(self, what: str, attempt: int, exc: BaseException,
                   delay: float) -> None:
        print(f"[{self.config.name}] transient {what} failure "
              f"(attempt {attempt}/{self.retry_policy.max_retries}): {exc} "
              f"— retrying in {delay:.2f}s", file=sys.stderr, flush=True)
        log_resilience_event(self.logger, self._batch_count,
                             {f"{what}_retries": float(attempt)})

    def resume(self, epoch: Optional[int] = None,
               verify: Optional[str] = None) -> Optional[int]:
        """Restore both networks and both optimizers from the latest (or
        the given) checkpoint, verified as `verify` (default
        `config.resume_verify`) says; the restored epoch, or None."""
        payload, _, got = self.ckpt.restore(
            epoch, verify=verify if verify is not None
            else self.config.resume_verify)
        if got is None:
            return None
        self.gen_state.load_state_dict(payload["gen"])
        self.disc_state.load_state_dict(payload["disc"])
        self.start_epoch = got + 1
        return got

    def train_batch(self, *batch) -> Metrics:
        raise NotImplementedError

    def _train_one_epoch(self, data: Iterable) -> Dict[str, float]:
        t0 = time.time()
        step_metrics: List[Metrics] = []
        clock = _StepClock(self.device)
        batches = resilient_batches(
            data, self.retry_policy,
            injector=self.faults if self.faults.active else None,
            on_retry=self._log_retry)
        for batch in batches:
            if self._shutdown is not None and self._shutdown.requested:
                break  # the step in flight finished; fit commits, exits 0
            if not isinstance(batch, tuple):
                batch = (batch,)
            step_metrics.append(self.train_batch(*batch))
            self._batch_count += 1
            clock.mark()
        out: Dict[str, float] = {}
        self.last_epoch_steps = []
        if step_metrics:
            keys = list(step_metrics[0])
            stacked = torch.stack([torch.stack([m[k].float() for k in keys])
                                   for m in step_metrics]).cpu()
            step_ms = clock.step_ms()
            self.last_epoch_steps = [
                {**dict(zip(keys, row.tolist())), "step_ms": ms}
                for row, ms in zip(stacked, step_ms)]
            out = dict(zip(keys, stacked.mean(dim=0).tolist()))
            if len(step_ms) > 1:
                out["step_ms"] = statistics.median(step_ms[1:])
        out["epoch_seconds"] = time.time() - t0
        return out

    def _recover_from_divergence(self, epoch: int) -> Optional[int]:
        """Roll both networks and both optimizers back to the last
        committed {gen, disc} checkpoint and multiply both LR scales by
        `config.recovery_lr_factor` (persistently). Returns the restored
        epoch, or None when nothing is committed."""
        got = self.resume()
        if got is None:
            return None
        self._recoveries += 1
        self._recovery_scale *= self.config.recovery_lr_factor
        for state in (self.gen_state, self.disc_state):
            state.optimizer.set_lr_scale(self._recovery_scale)
        say(f"[{self.config.name}] divergence recovery {self._recoveries}: "
            f"epoch {epoch} diverged — rolled back to epoch {got}, LR scale "
            f"now {self._recovery_scale:g}")
        log_resilience_event(
            self.logger, self._batch_count,
            {"divergence_recoveries": float(self._recoveries),
             "lr_scale": self._recovery_scale}, epoch=epoch)
        return got

    def fit(self, train_data_fn: Callable[[int], Iterable],
            total_epochs: Optional[int] = None,
            save_every: int = 2) -> Dict[str, float]:
        """Train epochs start_epoch..total_epochs; save every `save_every`
        epochs and at the last (`DCGAN/tensorflow/main.py:81-83`). A
        non-finite mean metric rolls back and retries under
        `config.recover_on_divergence`, then halts with the checkpoint to
        resume from; SIGTERM/SIGINT commit the epoch and raise
        PreemptionExit. Returns the last epoch's mean metrics, with the
        last save committed."""
        total_epochs = total_epochs or self.config.total_epochs
        metrics: Dict[str, float] = {}
        recoveries_left = self.config.recover_on_divergence
        with contextlib.ExitStack() as stack:
            if self.config.graceful_shutdown:
                self._shutdown = stack.enter_context(GracefulShutdown(
                    what="finishing the step, saving a checkpoint, then "
                         "exiting 0"))
            stack.callback(setattr, self, "_shutdown", None)
            epoch = self.start_epoch
            while epoch <= total_epochs:
                metrics = self._train_one_epoch(train_data_fn(epoch))
                # logged before the divergence check: the diverged epoch's
                # metrics belong in the stream
                self.logger.log(epoch, metrics, epoch=epoch, prefix="train_")
                if self._shutdown is not None and self._shutdown.requested:
                    self.ckpt.save(epoch, self._payload())
                    self.ckpt.flush()
                    raise PreemptionExit(
                        epoch,
                        f"[{self.config.name}] graceful preemption: "
                        f"checkpoint committed at epoch {epoch} — relaunch "
                        f"with --resume to continue")
                if self.config.halt_on_nonfinite and any(
                        not math.isfinite(v) for v in metrics.values()):
                    if recoveries_left > 0:
                        rolled = self._recover_from_divergence(epoch)
                        if rolled is not None:
                            recoveries_left -= 1
                            epoch = rolled + 1
                            continue
                    divergence_halt(self.config, self.ckpt, epoch,
                                    f"mean metrics contain a non-finite "
                                    f"value ({metrics})",
                                    resume_cmd="--resume")
                if epoch % save_every == 0 or epoch == total_epochs:
                    self.ckpt.save(epoch, self._payload())
                epoch += 1
        self.ckpt.flush()
        return metrics

    def close(self) -> None:
        try:
            self.ckpt.close()
        finally:
            self.logger.close()


# -- DCGAN ----------------------------------------------------------------------

def make_dcgan_train_step(noise_dim: int) -> Callable:
    """(gen_state, disc_state, images[, noise]) -> {gen_loss, disc_loss},
    updating both states in place. `noise` (B, noise_dim) defaults to a
    normal draw from the generator state's (seed, step) `noise` stream; the
    discriminator's three passes draw their dropout masks from streams of
    their own."""

    def step(gen_state: TrainState, disc_state: TrainState,
             images: torch.Tensor,
             noise: Optional[torch.Tensor] = None) -> Metrics:
        gen, disc = gen_state.model, disc_state.model
        if noise is None:
            noise = torch.randn((images.shape[0], noise_dim),
                                generator=gen_state.step_generator("noise"),
                                device=images.device)
        gen.train()
        disc.train()
        fake = gen(noise)
        g_loss = _bce_logits(disc(fake, gen_state.step_generator(
            "dropout_gen")), 1.0)
        d_loss = (_bce_logits(disc(images, gen_state.step_generator(
            "dropout_real")), 1.0)
            + _bce_logits(disc(fake.detach(), gen_state.step_generator(
                "dropout_fake")), 0.0))
        # both gradients against the pre-update parameters (the
        # reference's two tapes): the generator's is taken before either
        # update, and the discriminator's loss sees only detached fakes
        _apply(gen_state, g_loss)
        _apply(disc_state, d_loss)
        return {"gen_loss": g_loss.detach(), "disc_loss": d_loss.detach()}

    return annotate_step(step, compute_dtype=torch.float32, kind="train")


class DCGANTrainer(AdversarialTrainer):
    """The DCGAN pair on MNIST-shaped (28, 28, 1) images in [-1, 1]
    (`DCGAN/tensorflow/main.py:73-87`)."""

    def __init__(self, config: TrainConfig, workdir: str = "runs/dcgan", *,
                 device=None, noise_dim: int = 100):
        self._init_common(config, workdir, device)
        self.noise_dim = noise_dim
        init = torch.Generator().manual_seed(config.seed)
        self.generator = DCGANGenerator(noise_dim, generator=init)
        self.discriminator = DCGANDiscriminator(generator=init)
        steps_per_epoch = max(1, config.data.train_examples
                              // config.batch_size)
        self.gen_state = _state(self.generator, config, steps_per_epoch,
                                self.device)
        self.disc_state = _state(self.discriminator, config, steps_per_epoch,
                                 self.device)
        self.train_step = make_dcgan_train_step(noise_dim)
        say(f"[{config.name}] generator params="
            f"{sum(p.numel() for p in self.generator.parameters()):,} "
            f"discriminator params="
            f"{sum(p.numel() for p in self.discriminator.parameters()):,} "
            f"device={self.device} steps/epoch={steps_per_epoch}")

    def train_batch(self, images) -> Metrics:
        (images,) = self._stage(images)
        return self.train_step(self.gen_state, self.disc_state, images)

    def generate(self, num: int, seed: int = 42) -> np.ndarray:
        """`num` (28, 28, 1) samples in [-1, 1] from normal noise drawn
        with `seed`, in inference mode (`DCGAN/tensorflow/inference.py`)."""
        noise = torch.randn((num, self.noise_dim), generator=torch.Generator(
            self.device).manual_seed(seed), device=self.device)
        with torch.inference_mode():
            return self.generator.eval()(noise).cpu().numpy()


# -- CycleGAN -------------------------------------------------------------------

def make_cyclegan_generator_step() -> Callable:
    """Generator phase (`train.py:150-205`): (gen_state, disc_state,
    real_a, real_b) -> (metrics, fake_a2b, fake_b2a), updating the
    generators in place; the discriminators' BatchNorm statistics advance
    in their train-mode passes here."""

    def step(gen_state: TrainState, disc_state: TrainState,
             real_a: torch.Tensor, real_b: torch.Tensor):
        g, d = gen_state.model, disc_state.model
        g.train()
        d.train()
        fake_a2b = g["a2b"](real_a)          # cycle A -> B -> A
        recon_b2a = g["b2a"](fake_a2b)
        fake_b2a = g["b2a"](real_b)          # cycle B -> A -> B
        recon_a2b = g["a2b"](fake_b2a)
        identity_a2b = g["a2b"](real_b)      # identity terms
        identity_b2a = g["b2a"](real_a)
        loss_gan_a2b = _mse(d["b"](fake_a2b), 1.0)
        loss_gan_b2a = _mse(d["a"](fake_b2a), 1.0)
        loss_cycle_a2b2a = _mae(recon_b2a, real_a)
        loss_cycle_b2a2b = _mae(recon_a2b, real_b)
        loss_id_a2b = _mae(identity_a2b, real_b)
        loss_id_b2a = _mae(identity_b2a, real_a)
        total = (loss_gan_a2b + loss_gan_b2a
                 + (loss_cycle_a2b2a + loss_cycle_b2a2b) * LAMBDA_CYCLE
                 + (loss_id_a2b + loss_id_b2a) * LAMBDA_ID)
        _apply(gen_state, total)
        metrics = {"loss_gen_a2b": loss_gan_a2b,
                   "loss_gen_b2a": loss_gan_b2a,
                   "loss_cycle_a2b2a": loss_cycle_a2b2a,
                   "loss_cycle_b2a2b": loss_cycle_b2a2b,
                   "loss_id_a2b": loss_id_a2b, "loss_id_b2a": loss_id_b2a,
                   "loss_gen_total": total}
        return ({k: v.detach() for k, v in metrics.items()},
                fake_a2b.detach(), fake_b2a.detach())

    return annotate_step(step, compute_dtype=torch.float32, kind="train")


def make_cyclegan_discriminator_step() -> Callable:
    """Discriminator phase (`train.py:207-246`): (disc_state, real_a,
    real_b, fake_a2b, fake_b2a) -> metrics, (real + fake) / 2 LSGAN per
    domain, one optimizer over both discriminators."""

    def step(disc_state: TrainState, real_a, real_b, fake_a2b, fake_b2a):
        d = disc_state.model
        d.train()
        loss_dis_a = (_mse(d["a"](real_a), 1.0)
                      + _mse(d["a"](fake_b2a), 0.0)) * 0.5
        loss_dis_b = (_mse(d["b"](real_b), 1.0)
                      + _mse(d["b"](fake_a2b), 0.0)) * 0.5
        total = loss_dis_a + loss_dis_b
        _apply(disc_state, total)
        return {"loss_dis_a": loss_dis_a.detach(),
                "loss_dis_b": loss_dis_b.detach(),
                "loss_dis_total": total.detach()}

    return annotate_step(step, compute_dtype=torch.float32, kind="train")


class CycleGANTrainer(AdversarialTrainer):
    """The two-phase CycleGAN trainer (`CycleGAN/tensorflow/train.py:
    248-344`): generator phase, the two host pools (seeds `seed` and
    `seed + 1`), discriminator phase. `steps_per_epoch` anchors the
    linear decay to the real epoch length (default train_examples /
    batch_size)."""

    def __init__(self, config: TrainConfig, workdir: str = "runs/cyclegan",
                 *, device=None, n_blocks: int = 9,
                 pool_size: int = 50, steps_per_epoch: Optional[int] = None):
        self._init_common(config, workdir, device)
        init = torch.Generator().manual_seed(config.seed)
        self.generators = torch.nn.ModuleDict({
            name: CycleGANGenerator(n_blocks, generator=init)
            for name in ("a2b", "b2a")})
        self.discriminators = torch.nn.ModuleDict({
            name: PatchGANDiscriminator(generator=init)
            for name in ("a", "b")})
        steps_per_epoch = steps_per_epoch or max(
            1, config.data.train_examples // config.batch_size)
        self.gen_state = _state(self.generators, config, steps_per_epoch,
                                self.device)
        self.disc_state = _state(self.discriminators, config,
                                 steps_per_epoch, self.device)
        self.gen_step = make_cyclegan_generator_step()
        self.disc_step = make_cyclegan_discriminator_step()
        # one pool per fake stream (`train.py:55-56`)
        self.pool_a2b = ImagePool(pool_size, seed=config.seed)
        self.pool_b2a = ImagePool(pool_size, seed=config.seed + 1)
        say(f"[{config.name}] generators params="
            f"{sum(p.numel() for p in self.generators.parameters()):,} "
            f"discriminators params="
            f"{sum(p.numel() for p in self.discriminators.parameters()):,} "
            f"device={self.device} steps/epoch={steps_per_epoch}")

    def train_batch(self, images_a, images_b) -> Metrics:
        """Generator phase -> host pools -> discriminator phase
        (`train.py:248-255`)."""
        real_a, real_b = self._stage(images_a, images_b)
        gm, fake_a2b, fake_b2a = self.gen_step(self.gen_state,
                                               self.disc_state, real_a,
                                               real_b)
        fa, fb = self._stage(self.pool_a2b.query(fake_a2b.cpu().numpy()),
                             self.pool_b2a.query(fake_b2a.cpu().numpy()))
        dm = self.disc_step(self.disc_state, real_a, real_b, fa, fb)
        return {**gm, **dm}

    def translate(self, images: np.ndarray, direction: str = "a2b"
                  ) -> np.ndarray:
        """One generator on (B, H, W, 3) images in [-1, 1], in inference
        mode (`CycleGAN/tensorflow/inference.py:34-63`)."""
        (x,) = self._stage(np.asarray(images, np.float32))
        with torch.inference_mode():
            return self.generators[direction].eval()(x).cpu().numpy()
