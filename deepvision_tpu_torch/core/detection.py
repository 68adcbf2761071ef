"""Detection (YOLO V3) steps and trainer (own copy of
deepvision_tpu/core/detection.py: `yolo_grid_sizes`, `make_yolo_train_step`,
`make_yolo_eval_step`, `DetectionTrainer`).

Each step is a plain function on device tensors: the labels are encoded on
the device, then forward, `yolo_loss` (whose ignore mask runs the best-IoU
kernel once for all three scales), the batch mean, and — in training — backward and
the Adam update. Nothing in a step waits for the device. `make_predict_step`,
NMS and mAP evaluation are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..ops import yolo as yolo_ops
from .config import UNIT_RANGE_NORM, TrainConfig
from .steps import normalize_input
from .train_state import TrainState
from .trainer import LossWatchedTrainer

Step = Callable[..., Dict[str, torch.Tensor]]


def yolo_grid_sizes(image_size: int) -> Sequence[int]:
    """Grids at strides 8/16/32, finest first — (52, 26, 13) at 416px."""
    return (image_size // 8, image_size // 16, image_size // 32)


def _encode(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
            num_classes: int, grid_sizes: Sequence[int]):
    # one-hot as jax.nn.one_hot: a class id outside [0, C) is all zeros
    onehot = (classes.long()[..., None] == torch.arange(
        num_classes, device=classes.device)).float()
    return yolo_ops.encode_labels(onehot, boxes, valid, grid_sizes)


def make_yolo_train_step(*, num_classes: int, grid_sizes: Sequence[int],
                         compute_dtype: torch.dtype = torch.bfloat16,
                         input_norm=None) -> Step:
    """(state, images, boxes, classes, valid) -> metrics, updating `state`
    in place. boxes: (B, N, 4) normalized corner ground truth padded to
    N = MAX_BOXES; classes (B, N) int; valid (B, N) 0/1. Metrics are device
    scalars: `loss` (the batch mean) and `xy/wh/class/obj_loss`."""

    def step(state: TrainState, images, boxes, classes, valid):
        images = normalize_input(images, input_norm, compute_dtype)
        y_trues = _encode(boxes, classes, valid, num_classes, grid_sizes)
        state.model.train()
        outputs = state.model(images)
        comp = yolo_ops.yolo_loss(y_trues, outputs, boxes, valid, num_classes)
        loss = comp["total"].mean()
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(),
                **{f"{k}_loss": v.detach().mean() for k, v in comp.items()
                   if k != "total"}}

    return step


def make_yolo_eval_step(*, num_classes: int, grid_sizes: Sequence[int],
                        compute_dtype: torch.dtype = torch.bfloat16,
                        input_norm=None) -> Step:
    """Validation loss step: the running BatchNorm statistics, raw heads."""

    @torch.no_grad()
    def step(state: TrainState, images, boxes, classes, valid):
        images = normalize_input(images, input_norm, compute_dtype)
        y_trues = _encode(boxes, classes, valid, num_classes, grid_sizes)
        state.model.eval()
        outputs = state.model(images, decode=False)
        comp = yolo_ops.yolo_loss(y_trues, outputs, boxes, valid, num_classes)
        return {"loss": comp["total"].mean()}

    return step


class DetectionTrainer(LossWatchedTrainer):
    """YOLO trainer: the shared epoch/checkpoint/plateau machinery with the
    detection steps, watching the validation loss."""

    def __init__(self, config: TrainConfig, *, device=None,
                 workdir: Optional[str] = None,
                 model: Optional[torch.nn.Module] = None):
        super().__init__(config, device=device, workdir=workdir, model=model)
        kw = dict(num_classes=config.data.num_classes,
                  grid_sizes=yolo_grid_sizes(config.data.image_size),
                  compute_dtype=getattr(torch, config.dtype),
                  input_norm=(UNIT_RANGE_NORM
                              if config.data.normalize_on_device else None))
        self.train_step = make_yolo_train_step(**kw)
        self.eval_step = make_yolo_eval_step(**kw)
