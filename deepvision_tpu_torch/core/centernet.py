"""CenterNet (ObjectsAsPoints) steps, inference and trainer (own copy of
deepvision_tpu/core/centernet.py: `make_centernet_train_step`,
`make_centernet_eval_step`, `CenterNetTrainer`,
`make_centernet_predict_step`, `evaluate_map`).

The same padded ground-truth batches as YOLO (data/detection.py,
data/digits.py). Each step encodes the targets on the device
(ops/centernet.py), runs the forward and the summed per-stack losses; in
training, backward and the Adam update. Metrics: `loss` (the batch mean)
and `heatmap_loss`, `size_loss`, `offset_loss`. Nothing in a step waits
for the device. Under a process group the train step runs the state's
DDP wrapper on the rank's rows (the losses are per example, so the mean
of the ranks' means is the global batch's) and returns the global means.

The predict step decodes the LAST stack's heads (the earlier ones are
train-time supervision) by peak picking and top-k, in inference mode on
the EMA weights when the state keeps them; `evaluate_map` feeds it to the
mAP evaluator (core/eval_detection.py). Remat comes with the state
(core/remat.py) and `log_grad_norm` adds the step metric `grad_norm`
(core/steps.py::maybe_grad_norm); the spatial shard_map step of the JAX
package is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..ops import centernet as cn_ops
from ..parallel import mesh
from ..utils.device import to_device, to_host
from .config import UNIT_RANGE_NORM, TrainConfig
from .detection import boxes_calibration_batch
from .steps import annotate_step, maybe_grad_norm, normalize_input
from .train_state import TrainState
from .trainer import LossWatchedTrainer

Step = Callable[..., Dict[str, torch.Tensor]]


def make_centernet_train_step(*, num_classes: int, grid: int,
                              compute_dtype: torch.dtype = torch.bfloat16,
                              input_norm=None,
                              log_grad_norm: bool = False) -> Step:
    """(state, images, boxes, classes, valid) -> metrics, updating `state`
    in place. boxes (B, N, 4) normalized corners padded to MAX_BOXES;
    classes (B, N) int; valid (B, N) 0/1."""

    def step(state: TrainState, images, boxes, classes, valid):
        images = normalize_input(images, input_norm, compute_dtype)
        targets = cn_ops.encode_labels(boxes, classes, valid, grid,
                                       num_classes)
        state.train_model.train()
        comp = cn_ops.centernet_loss(state.train_model(images), targets)
        loss = comp["total"].mean()
        state.optimizer.zero_grad()
        loss.backward()
        norm = maybe_grad_norm(log_grad_norm, state.model.parameters())
        state.optimizer.step()
        state.step += 1
        return mesh.global_means({
            "loss": loss.detach(),
            **{f"{k}_loss": v.detach().mean() for k, v in comp.items()
               if k != "total"}, **norm})

    return annotate_step(step, compute_dtype=compute_dtype, kind="train")


def make_centernet_eval_step(*, num_classes: int, grid: int,
                             compute_dtype: torch.dtype = torch.bfloat16,
                             input_norm=None) -> Step:
    """Validation loss step: the running BatchNorm statistics."""

    @torch.no_grad()
    def step(state: TrainState, images, boxes, classes, valid):
        images = normalize_input(images, input_norm, compute_dtype)
        targets = cn_ops.encode_labels(boxes, classes, valid, grid,
                                       num_classes)
        state.model.eval()
        comp = cn_ops.centernet_loss(state.model(images), targets)
        return {"loss": comp["total"].mean()}

    return annotate_step(step, compute_dtype=compute_dtype, kind="eval")


class CenterNetTrainer(LossWatchedTrainer):
    """The detection batches of DetectionTrainer with the CenterNet steps
    (output stride 4: grid = image_size // 4), watching the validation
    loss."""

    def __init__(self, config: TrainConfig, *, device=None,
                 workdir: Optional[str] = None,
                 model: Optional[torch.nn.Module] = None):
        super().__init__(config, device=device, workdir=workdir, model=model)
        kw = dict(num_classes=config.data.num_classes,
                  grid=config.data.image_size // 4,
                  compute_dtype=getattr(torch, config.dtype),
                  input_norm=(UNIT_RANGE_NORM
                              if config.data.normalize_on_device else None))
        self.train_step = make_centernet_train_step(
            **kw, log_grad_norm=config.log_grad_norm)
        self.eval_step = make_centernet_eval_step(**kw)

    def _calibration_batch(self, sample_shape, batch_size: int,
                           seed: int = 0) -> tuple:
        """`boxes_calibration_batch` of this config."""
        return boxes_calibration_batch(self.config, sample_shape, batch_size,
                                       seed=seed)


def predict_heads(model: torch.nn.Module, images: torch.Tensor,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> Dict[str, torch.Tensor]:
    """The last stack's heads of `model`'s forward on `images` at the
    compute dtype. The caller holds the inference mode and the model's eval
    mode."""
    return model(images.to(compute_dtype))[-1]


def make_centernet_predict_step(*, compute_dtype: torch.dtype = torch.bfloat16,
                                max_detections: int = 100) -> Callable:
    """(state, images) -> (boxes (B, K, 4), scores (B, K) descending,
    classes (B, K) int32), K = max_detections always: callers count the
    valid rows by a score threshold."""

    def step(state: TrainState, images: torch.Tensor):
        model = state.model
        with state.ema_weights(), torch.inference_mode():
            model.eval()
            return cn_ops.decode(predict_heads(model, images, compute_dtype),
                                 max_detections=max_detections)

    return annotate_step(step, compute_dtype=compute_dtype, kind="predict")


def evaluate_map(state: TrainState, batches: Iterable, *, num_classes: int,
                 metric: str = "coco", score_thresh: float = 0.05,
                 compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """CenterNet mAP over (images, boxes, classes, valid[, difficult])
    numpy batches on the state's device: metric "coco" -> mAP@[.5:.95],
    "voc" -> all-point mAP@0.5, "voc07" -> 11-point."""
    from .eval_detection import make_evaluator

    ev = make_evaluator(metric, num_classes)
    predict = make_centernet_predict_step(compute_dtype=compute_dtype)
    device = next(state.model.parameters()).device
    for batch in batches:
        images, gt_boxes, gt_classes, gt_valid = batch[:4]
        boxes, scores, classes = (t.cpu().numpy() for t in predict(
            state, to_device(images, device)))
        counts = (scores >= score_thresh).sum(axis=1)  # scores descend
        ev.add_batch(boxes, scores, classes, counts, to_host(gt_boxes),
                     to_host(gt_classes), to_host(gt_valid),
                     gt_difficult=(to_host(batch[4]) if len(batch) > 4
                                   else None))
    return ev.summarize()
