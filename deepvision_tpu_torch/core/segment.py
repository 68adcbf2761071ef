"""Semantic segmentation steps and trainer (own copy of
deepvision_tpu/core/segment.py: `DICE_WEIGHT`, `DICE_EPS`,
`dice_weight_for`, `soft_dice_loss`, `segmentation_loss`,
`pixel_accuracy`, the train, eval and predict steps and
`SegmentationTrainer`).

The loss is the mean pixel-wise softmax cross-entropy over the whole
(batch x H x W) slab, plus 0.5 x soft dice for `loss="xent_dice"`. The
eval step returns the batch loss and the (C, C) confusion counts
(core/metrics.py), which the trainer sums on the host into mIoU and pixel
accuracy; the predict step returns int32 (B, H, W) class ids, the answer
the engine serves. With `--device-augment` the batches arrive as uint8
image and mask pairs at the decode size and the paired augment
(data/device_augment.py) crops and flips both with one draw from the
state's (seed, step) generator on the `augment` stream.

A step is a plain function on device tensors that updates the state in
place; nothing in it waits for the device. Under a process group the
train step runs the DDP wrapper on the rank's rows (every rank holds as
many pixels, so the mean of the ranks' losses is the global batch's) and
returns the global means; evaluation splits each global batch over the
ranks and all-reduces the confusion counts. Remat comes with the state
(core/remat.py) and `log_grad_norm` adds the step metric `grad_norm`
(core/steps.py::maybe_grad_norm); mixup and CutMix are refused, as in the
JAX trainer. The shard_map step over a spatial mesh is not ported
(ROADMAP A6).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn.functional as F

from ..data import device_augment as daug
from ..models.common import at_least_f32
from ..parallel import mesh
from . import metrics as metrics_lib
from .config import TrainConfig
from .steps import (_check_norm, annotate_step, maybe_grad_norm,
                    normalize_input)
from .train_state import TrainState
from .trainer import Trainer

# "xent_dice" adds the soft dice at this weight
DICE_WEIGHT = 0.5
DICE_EPS = 1.0

Step = Callable[..., Dict[str, torch.Tensor]]


def dice_weight_for(config: TrainConfig) -> float:
    """The dice weight of the config's `loss`: "softmax_xent" (or "xent")
    is pure cross-entropy, "xent_dice" adds the dice; any other raises."""
    if config.loss in ("softmax_xent", "xent"):
        return 0.0
    if config.loss == "xent_dice":
        return DICE_WEIGHT
    raise ValueError(
        f"segmentation config {config.name!r} declares unknown loss "
        f"{config.loss!r}; expected 'softmax_xent' or 'xent_dice'")


def soft_dice_loss(logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Mean over classes and batch of 1 - dice, dice_c = (2 sum p_c y_c +
    eps) / (sum p_c + sum y_c + eps) with the softmax p and the one-hot
    ground truth y summed over each example's pixels."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(at_least_f32(logits), dim=-1)
    onehot = F.one_hot(masks.long(), num_classes).to(probs.dtype)
    inter = (probs * onehot).sum(dim=(1, 2))                 # (B, C)
    denom = probs.sum(dim=(1, 2)) + onehot.sum(dim=(1, 2))
    dice = (2.0 * inter + DICE_EPS) / (denom + DICE_EPS)
    return (1.0 - dice).mean()


def segmentation_loss(logits: torch.Tensor, masks: torch.Tensor,
                      dice_weight: float = 0.0) -> Dict[str, torch.Tensor]:
    """{'total', 'ce'[, 'dice']} of (B, H, W, C) logits against (B, H, W)
    class ids, in f32 (f64 for f64 logits)."""
    logits = at_least_f32(logits)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         masks.reshape(-1).long())
    comp = {"ce": ce, "total": ce}
    if dice_weight > 0.0:
        dice = soft_dice_loss(logits, masks)
        comp["dice"] = dice
        comp["total"] = ce + dice_weight * dice
    return comp


def pixel_accuracy(logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == masks.long()).float().mean()


def make_segmentation_train_step(*, compute_dtype: torch.dtype = torch.bfloat16,
                                 input_norm=None,
                                 device_augment: Optional[Callable] = None,
                                 dice_weight: float = 0.0,
                                 log_grad_norm: bool = False) -> Step:
    """(state, images, masks) -> {loss, pixel_acc, ce_loss[, dice_loss,
    grad_norm]},
    updating `state` in place. `device_augment` is the paired train stage
    (it replaces `input_norm`)."""
    _check_norm(input_norm, device_augment)

    def step(state: TrainState, images, masks):
        if device_augment is not None:
            with torch.profiler.record_function("device_augment"):
                images, masks = device_augment(
                    images, masks, state.step_generator("augment"))
        else:
            images = normalize_input(images, input_norm, compute_dtype)
        state.train_model.train()
        logits = state.train_model(images)
        comp = segmentation_loss(logits, masks, dice_weight)
        loss = comp["total"]
        state.optimizer.zero_grad()
        loss.backward()
        norm = maybe_grad_norm(log_grad_norm, state.model.parameters())
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            return mesh.global_means({
                "loss": loss.detach(),
                "pixel_acc": pixel_accuracy(logits, masks),
                **{f"{k}_loss": v.detach() for k, v in comp.items()
                   if k != "total"}, **norm})

    return annotate_step(step, compute_dtype=compute_dtype, kind="train")


def make_segmentation_eval_step(*, num_classes: int,
                                compute_dtype: torch.dtype = torch.bfloat16,
                                input_norm=None,
                                device_augment: Optional[Callable] = None,
                                dice_weight: float = 0.0) -> Step:
    """(state, images, masks) -> {'loss', 'confusion'}: the batch's loss on
    the running BatchNorm statistics and its (C, C) confusion counts.
    `device_augment` is the paired eval stage (the centred crop)."""
    _check_norm(input_norm, device_augment)

    @torch.no_grad()
    def step(state: TrainState, images, masks):
        if device_augment is not None:
            images, masks = device_augment(images, masks)
        else:
            images = normalize_input(images, input_norm, compute_dtype)
        state.model.eval()
        logits = state.model(images)
        comp = segmentation_loss(logits, masks, dice_weight)
        return {"loss": comp["total"],
                "confusion": metrics_lib.confusion_matrix(
                    logits.argmax(dim=-1), masks, num_classes)}

    return annotate_step(step, compute_dtype=compute_dtype, kind="eval")


def make_segmentation_predict_step(*, compute_dtype: torch.dtype =
                                   torch.bfloat16,
                                   input_norm=None) -> Callable:
    """(state, images) -> int32 (B, H, W) class ids: the argmax of the f32
    logits in inference mode, on the EMA weights when the state keeps
    them (the weights evaluation scores and the engine serves)."""

    def step(state: TrainState, images: torch.Tensor) -> torch.Tensor:
        model = state.model
        with state.ema_weights(), torch.inference_mode():
            model.eval()
            x = normalize_input(images, input_norm, compute_dtype)
            return model(x).argmax(dim=-1).to(torch.int32)

    return annotate_step(step, compute_dtype=compute_dtype, kind="predict")


class SegmentationTrainer(Trainer):
    """U-Net trainer: the shared epoch, checkpoint and plateau machinery
    with the segmentation steps, the paired device augment, and a
    confusion-matrix evaluation that watches the mIoU."""

    default_watch = ("miou", "max")

    def __init__(self, config: TrainConfig, *, device=None,
                 workdir: Optional[str] = None,
                 model: Optional[torch.nn.Module] = None):
        if config.mixup_alpha or config.cutmix_alpha:
            # blending class-id masks is meaningless; an error beats a
            # silent no-op
            raise ValueError(
                "mixup_alpha/cutmix_alpha are classification-only; "
                "SegmentationTrainer trains on per-pixel class ids — use "
                "the paired device augmentation (--device-augment) instead")
        super().__init__(config, device=device, workdir=workdir, model=model)
        compute_dtype = getattr(torch, config.dtype)
        data = config.data
        input_norm = ((data.mean, data.std) if data.normalize_on_device
                      else None)
        train_augment = eval_augment = None
        if config.device_augment:
            kw = dict(mean=daug.channel_stats(data.mean, data.channels),
                      std=daug.channel_stats(data.std, data.channels),
                      compute_dtype=compute_dtype)
            train_augment = daug.make_paired_train_augment(data.image_size,
                                                           **kw)
            eval_augment = daug.make_paired_eval_augment(data.image_size, **kw)
            input_norm = None          # the paired augment normalizes
        dice_weight = dice_weight_for(config)
        self.train_step = make_segmentation_train_step(
            compute_dtype=compute_dtype, input_norm=input_norm,
            device_augment=train_augment, dice_weight=dice_weight,
            log_grad_norm=config.log_grad_norm)
        self.eval_step = make_segmentation_eval_step(
            num_classes=data.num_classes, compute_dtype=compute_dtype,
            input_norm=input_norm, device_augment=eval_augment,
            dice_weight=dice_weight)

    def _evaluate(self, data: Iterable) -> dict:
        """Confusion counts summed on the host (`StreamingConfusion`) over
        fixed-shape global batches, each rank evaluating its rows; mIoU and
        pixel accuracy from the totals, the loss the mean of the finite
        batch losses (a non-finite batch is skipped, as the JAX trainer
        does)."""
        stream = metrics_lib.StreamingConfusion(self.config.data.num_classes)
        total, n = 0.0, 0
        for batch in data:
            rows = (mesh.shard_rows(a, self.rank, self.world) for a in batch)
            out = self.eval_step(self.state, *self._to_device(rows))
            loss = float(mesh.global_means({"loss": out["loss"]})["loss"])
            if math.isfinite(loss):
                total += loss
                n += 1
            stream.update(mesh.all_reduce_(out["confusion"]).cpu().numpy())
        if n == 0:
            return {}
        scores = stream.result()
        return {"loss": total / n, "count": float(n),
                "miou": float(scores["miou"]),
                "pixel_acc": float(scores["pixel_acc"])}
