"""Classification train and eval steps, and the input normalization shared
by every step and predict path (own copy of deepvision_tpu/core/steps.py:
`_normalize_input`, `make_classification_train_step`,
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
the global batch's means. The model and spatial axes of the mesh, remat,
mixup/cutmix and the grad correction of the JAX steps are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..parallel import mesh
from . import losses
from .train_state import TrainState

Step = Callable[..., Dict[str, torch.Tensor]]


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


def make_classification_train_step(
        *, label_smoothing: float = 0.0, aux_weight: float = 0.3,
        compute_dtype: torch.dtype = torch.bfloat16,
        input_norm=None, augment: Optional[Callable] = None) -> Step:
    """(state, images, labels) -> {loss, top1, top5}, device scalars,
    updating `state` in place: the device augment (if any), forward in
    train mode with this step's dropout generator, the (smoothed) loss,
    backward, one optimizer step (or one micro-batch of an accumulation).
    Top-k is of the main head."""
    _check_norm(input_norm, augment)

    def step(state: TrainState, images, labels):
        if augment is not None:
            with torch.profiler.record_function("device_augment"):
                images = augment(images, state.step_generator("augment"))
        else:
            images = normalize_input(images, input_norm, compute_dtype)
        state.train_model.train()
        outputs = state.train_model(images,
                                    generator=state.dropout_generator())
        loss = losses.classification_loss(outputs, labels, label_smoothing,
                                          aux_weight)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            return mesh.global_means({
                "loss": loss.detach(),
                **losses.topk_accuracies(outputs, labels)})

    return step


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

    return step
