"""Classification train and eval steps, the input normalization shared
by every step and predict path, and the levers every family's train step
shares (own copy of deepvision_tpu/core/steps.py: `_normalize_input`,
`maybe_grad_norm`, `make_classification_train_step`,
`make_multistep_train_step`, `make_epoch_train_step`,
`make_classification_eval_step`).

A step is a plain function on device tensors that updates the state in
place; nothing in it waits for the device. With `augment` (the device
augmentation of data/device_augment.py) the images arrive as uint8 at the
decode size and the augment crops and normalizes them, drawing from the
state's per-(seed, step) generator on its own stream; `input_norm` is then
off. Under a process group (parallel/mesh.py) a train step runs the
state's DDP wrapper on the rank's rows: each rank's loss is the mean over
its rows and DDP averages the gradients, which, the ranks holding equal
rows, is the gradient of the global batch's mean; the metrics come back as
the global batch's means.

The levers:
- `log_grad_norm`: `maybe_grad_norm`, the global L2 norm of the gradients
  after the backward and before the optimizer step (under DDP the reduced
  gradients; under accumulation the micro-batch's), the metric
  `grad_norm`.
- remat: the state's `remat` (core/remat.py), so every family's step gets
  it through `state.train_model`.
- mixup and CutMix: a draw (`draw_mix`: lam ~ Beta(a, a), the batch's
  permutation and CutMix's box centre) and an apply (`apply_mixup`,
  `apply_cutmix`), as the device augment splits its own. The draws come
  from a numpy generator on the host seeded per (seed, step) on the `mix`
  stream (`TrainState.step_numpy_rng`), the counterpart of JAX's
  `fold_in(step_rng, 1)` (the augment keeps its own stream, JAX's tag 2).
  The host was chosen over torch's generator because numpy draws Beta
  directly (torch's `Beta` samples from the global generator, which the
  port never uses), lam and the box are scalars the step needs on the
  host anyway (the box becomes a slice, lam a scalar factor), and the
  permutation reaches the card by one pinned, non-blocking copy: no
  device sync. Under a process group each rank mixes its own rows with
  its own draw (the rank joins the seed, as for the augment).
- k steps per dispatch and the whole epoch: `make_multistep_train_step`
  and `make_epoch_train_step` issue their steps back to back with no host
  sync between them, the EMA after each; the port's counterpart of
  `lax.scan`. The epoch's shuffle is a draw (`draw_epoch_permutation`,
  a function of (seed, epoch)) and an apply (`apply_epoch_permutation`).

The model and spatial axes of the mesh and the grad correction of the JAX
steps are not ported (ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..parallel import mesh
from . import losses
from .train_state import TrainState

Step = Callable[..., Dict[str, torch.Tensor]]


def annotate_step(fn: Callable, **claim) -> Callable:
    """Attach the factory's own declaration to the step it returns: the
    compute dtype and the kind (train, eval or predict), as
    `audit_claim`. The IR audit (deepvision_tpu_torch/check) traces the
    step and holds what it ran to exactly this claim, so the claim
    cannot drift from the construction site (JAX: `annotate_step`'s
    `_jaxvet`). Inert everywhere else."""
    fn.audit_claim = claim
    return fn


def _claimed_dtype(step_fn: Callable) -> Optional[torch.dtype]:
    """The compute dtype an inner step's factory declared (a wrapper of
    k steps or an epoch declares its inner step's)."""
    return getattr(step_fn, "audit_claim", {}).get("compute_dtype")


def normalize_input(images: torch.Tensor,
                    input_norm: Optional[Tuple[Sequence[float],
                                               Sequence[float]]],
                    compute_dtype: torch.dtype) -> torch.Tensor:
    """Cast to the compute dtype; with `input_norm=(mean, std)` the images
    are raw [0,255] pixels (uint8 transfer) normalized here on the device
    instead of on the host. Division and subtraction happen in f32 so uint8
    pixel values stay exact, then the result drops to the compute dtype
    once."""
    if input_norm is None:
        return images.to(compute_dtype)
    mean, std = input_norm
    mean = torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=images.device)
    images = images.to(torch.float32) / 255.0
    return ((images - mean) / std).to(compute_dtype)


def _check_norm(input_norm, augment) -> None:
    if augment is not None and input_norm is not None:
        raise ValueError("the device augment already normalizes; passing "
                         "input_norm too would normalize twice")


def maybe_grad_norm(enabled: bool, params: Iterable[torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """{'grad_norm': the global L2 norm of the parameters' gradients} when
    enabled, else {}: the one definition of the metric, shared by every
    family's train step. Called after the backward, before the optimizer
    step."""
    if not enabled:
        return {}
    grads = [p.grad for p in params if p.grad is not None]
    return {"grad_norm": torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))}


@dataclasses.dataclass
class MixDraws:
    """One step's mixup or CutMix draws: lam ~ Beta(a, a) in f32, the
    batch's permutation, and CutMix's box centre (cy, cx), uniform on
    [0, 1) in f32 (None for mixup)."""
    lam: float
    perm: np.ndarray
    centre: Optional[Tuple[float, float]] = None


def draw_mix(rng: np.random.Generator, batch: int, alpha: float,
             cutmix: bool) -> MixDraws:
    """A step's draws from its host generator (`TrainState.step_numpy_rng
    ("mix")`), with the JAX step's distributions."""
    lam = float(np.float32(rng.beta(alpha, alpha)))
    perm = rng.permutation(batch)
    centre = (tuple(float(v) for v in rng.random(2, dtype=np.float32))
              if cutmix else None)
    return MixDraws(lam, perm, centre)


def _perm_on(perm: np.ndarray, device: torch.device) -> torch.Tensor:
    """The permutation as an index tensor on `device`: on the card one
    pinned, non-blocking copy, so the step does not wait for the card."""
    t = torch.from_numpy(np.asarray(perm, np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def apply_mixup(images: torch.Tensor, draws: MixDraws,
                compute_dtype: torch.dtype) -> Tuple[torch.Tensor, float]:
    """lam·images + (1 - lam)·images[perm], lam rounded to the compute
    dtype first as the JAX step does; returns the blend and that lam (the
    loss's weight, widened to f32 exactly)."""
    lam = torch.tensor(draws.lam, dtype=torch.float32).to(compute_dtype)
    one_minus = float(1.0 - lam)
    perm = _perm_on(draws.perm, images.device)
    return (images * float(lam) + images[perm] * one_minus,
            float(lam.to(torch.float32)))


def cutmix_box(draws: MixDraws, height: int, width: int
               ) -> Tuple[int, int, int, int, float]:
    """(row0, row1, col0, col1, lam): the pasted box as half-open pixel
    ranges and lam re-derived as the exact kept fraction, in f32 as the
    JAX step computes them. The box has area fraction 1 - lam0 around
    the centre, clipped to the image; a pixel (i, j) is inside when
    y1 <= i < y2 and x1 <= j < x2, so the ranges start at ceil(y1) and
    end before ceil(y2)."""
    f32 = np.float32
    r = np.sqrt(f32(1.0) - f32(draws.lam))
    half = r / f32(2.0)
    cy, cx = (f32(v) for v in draws.centre)

    def span(c, n):
        lo = np.clip((c - half) * f32(n), f32(0.0), f32(n))
        hi = np.clip((c + half) * f32(n), f32(0.0), f32(n))
        return int(np.ceil(lo)), max(int(np.ceil(lo)), int(np.ceil(hi)))

    r0, r1 = span(cy, height)
    c0, c1 = span(cx, width)
    inside = f32((r1 - r0) * (c1 - c0)) / f32(height * width)
    return r0, r1, c0, c1, float(f32(1.0) - inside)


def apply_cutmix(images: torch.Tensor, draws: MixDraws
                 ) -> Tuple[torch.Tensor, float]:
    """The box of images[perm] pasted into a copy of the NHWC batch (the
    input, which may be a view of the epoch cache, is left as it was);
    returns the mixed batch and lam, the kept fraction."""
    r0, r1, c0, c1, lam = cutmix_box(draws, images.shape[1], images.shape[2])
    out = images.clone()
    if r1 > r0 and c1 > c0:
        perm = _perm_on(draws.perm, images.device)
        out[:, r0:r1, c0:c1] = images[perm, r0:r1, c0:c1]
    return out, lam


def make_classification_train_step(
        *, label_smoothing: float = 0.0, aux_weight: float = 0.3,
        compute_dtype: torch.dtype = torch.bfloat16,
        input_norm=None, augment: Optional[Callable] = None,
        mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0,
        log_grad_norm: bool = False,
        draw: Optional[Callable[..., MixDraws]] = None) -> Step:
    """(state, images, labels) -> {loss, top1, top5[, grad_norm]}, device
    scalars, updating `state` in place: the device augment (if any), mixup
    or CutMix (if either alpha is set), forward in train mode with this
    step's dropout generator, the (smoothed) loss, backward, one optimizer
    step (or one micro-batch of an accumulation). Top-k is of the main
    head against the primary labels. Under mixing the loss is
    lam·L(labels) + (1 - lam)·L(labels[perm]). `draw(state, batch)`
    replaces the step's own mix draws (a test feeds the JAX step's)."""
    _check_norm(input_norm, augment)
    if mixup_alpha > 0.0 and cutmix_alpha > 0.0:
        raise ValueError("mixup_alpha and cutmix_alpha are mutually "
                         "exclusive")
    alpha = mixup_alpha or cutmix_alpha
    cutmix = cutmix_alpha > 0.0
    if draw is None:
        def draw(state, batch):
            return draw_mix(state.step_numpy_rng("mix"), batch, alpha,
                            cutmix)

    def step(state: TrainState, images, labels):
        if augment is not None:
            with torch.profiler.record_function("device_augment"):
                images = augment(images, state.step_generator("augment"))
        else:
            images = normalize_input(images, input_norm, compute_dtype)
        draws = None
        if alpha > 0.0:
            draws = draw(state, images.shape[0])
            images, lam = (apply_cutmix(images, draws) if cutmix
                           else apply_mixup(images, draws, compute_dtype))
            labels_b = labels[_perm_on(draws.perm, labels.device)]
        state.train_model.train()
        outputs = state.train_model(images,
                                    generator=state.dropout_generator())
        loss = losses.classification_loss(outputs, labels, label_smoothing,
                                          aux_weight)
        if draws is not None:
            loss = loss * lam + losses.classification_loss(
                outputs, labels_b, label_smoothing, aux_weight) * (1.0 - lam)
        state.optimizer.zero_grad()
        loss.backward()
        norm = maybe_grad_norm(log_grad_norm, state.model.parameters())
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            return mesh.global_means({
                "loss": loss.detach(),
                **losses.topk_accuracies(outputs, labels), **norm})

    return annotate_step(step, compute_dtype=compute_dtype, kind="train")


def step_and_ema(step_fn: Step, state: TrainState, batch: tuple
                 ) -> Dict[str, torch.Tensor]:
    """`step_fn` on a batch on the device, then the EMA update when the
    step applied an optimizer update (once per accumulation cycle)."""
    applied = state.optimizer.count
    metrics = step_fn(state, *batch)
    if state.ema is not None and state.optimizer.count != applied:
        with torch.profiler.record_function("ema_update"):
            state.update_ema()
    return metrics


def make_multistep_train_step(step_fn: Step, k: int) -> Callable:
    """(state, batches) -> (per-step metrics, their mean): k staged
    batches run as k steps issued back to back, each followed by its EMA
    update (the averaging cadence of k = 1), the step counter advancing
    by k; nothing waits for the card. The caller reads the mean once per
    dispatch (JAX: a `lax.scan` over the k batches)."""
    if k < 2:
        raise ValueError(f"steps_per_dispatch wrapper needs k >= 2, got {k}")

    def multi(state: TrainState, batches: Sequence[tuple]):
        if len(batches) != k:
            raise ValueError(f"a dispatch takes {k} batches, got "
                             f"{len(batches)}")
        per_step = [step_and_ema(step_fn, state, b) for b in batches]
        return per_step, {k: torch.stack([m[k].float() for m in per_step])
                          .mean() for k in per_step[0]}

    return annotate_step(multi,
                         compute_dtype=_claimed_dtype(step_fn), kind="train")


def draw_epoch_permutation(seed: int, epoch: int, n: int,
                           device: torch.device) -> torch.Tensor:
    """The on-device epoch's permutation of its `n` examples, drawn on
    `device` from a generator seeded by a hash of (seed, epoch): the same
    on every run and after a resume (JAX: `permutation(fold_in(
    fold_in(seed_key, epoch), EPOCH_SHUFFLE_TAG), n)`)."""
    digest = hashlib.blake2b(f"{seed}:epoch{epoch}:shuffle".encode(),
                             digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little") >> 1)
    return torch.randperm(n, generator=gen, device=device)


def apply_epoch_permutation(arrays: Sequence[torch.Tensor],
                            perm: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each (steps, batch, ...) array's examples reordered by `perm` over
    the flattened steps x batch axis (one shuffled copy of the epoch)."""
    out = []
    for a in arrays:
        flat = a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])
        out.append(flat[perm.to(a.device)].reshape(a.shape))
    return tuple(out)


def make_epoch_train_step(step_fn: Step) -> Callable:
    """(state, arrays, perm=None, on_step=None) -> per-step metrics: one
    pass over the cached (steps, batch, ...) arrays (data/
    device_cache.py), each step followed by its EMA update, with no host
    batch and no host sync; `perm` (from `draw_epoch_permutation`, or a
    test's) reorders the examples first. `on_step()` runs on the host
    after each step is issued (the trainer's clock and watchdog). The
    metrics come back per step, stacked by the caller (JAX: a `lax.scan`
    over the epoch)."""

    def epoch(state: TrainState, arrays: Sequence[torch.Tensor],
              perm: Optional[torch.Tensor] = None,
              on_step: Optional[Callable[[], None]] = None
              ) -> List[Dict[str, torch.Tensor]]:
        if perm is not None:
            arrays = apply_epoch_permutation(arrays, perm)
        per_step = []
        for i in range(arrays[0].shape[0]):
            per_step.append(step_and_ema(step_fn, state,
                                         tuple(a[i] for a in arrays)))
            if on_step is not None:
                on_step()
        return per_step

    return annotate_step(epoch,
                         compute_dtype=_claimed_dtype(step_fn), kind="train")


def make_classification_eval_step(
        *, compute_dtype: torch.dtype = torch.bfloat16,
        input_norm=None, augment: Optional[Callable] = None) -> Step:
    """(state, images, labels, mask) -> masked SUMS of the unsmoothed loss,
    top1 and top5, and `count` = sum(mask): a padded row (mask 0) adds
    nothing. The host divides by `count`. `augment` is the eval augment
    (centre crop and normalize)."""
    _check_norm(input_norm, augment)

    @torch.no_grad()
    def step(state: TrainState, images, labels, mask):
        images = (augment(images) if augment is not None
                  else normalize_input(images, input_norm, compute_dtype))
        state.model.eval()
        outputs = state.model(images)
        main = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
        xent = losses.per_example_xent(main, labels)
        correct = losses.topk_correct(outputs, labels)
        return {"loss": (xent * mask).sum(),
                **{k: (v * mask).sum() for k, v in correct.items()},
                "count": mask.sum()}

    return annotate_step(step, compute_dtype=compute_dtype, kind="eval")
