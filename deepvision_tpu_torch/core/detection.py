"""Detection (YOLO V3) steps, inference and trainer (own copy of
deepvision_tpu/core/detection.py: `boxes_calibration_batch`,
`yolo_grid_sizes`, `make_yolo_train_step`,
`make_yolo_eval_step`, `make_predict_step`, `evaluate_map`,
`DetectionTrainer`).

Each step is a plain function on device tensors: the labels are encoded on
the device, then forward, `yolo_loss` (whose ignore mask runs the best-IoU
kernel once for all three scales), the batch mean, and — in training — backward and
the Adam update. Nothing in a step waits for the device. Under a process
group the train step runs the state's DDP wrapper on the rank's rows
(`yolo_loss` is per image, so the mean of the ranks' means is the global
batch's) and returns the global means; the eval step runs the unwrapped
model. Remat comes with the state (core/remat.py), and `log_grad_norm`
adds the step metric `grad_norm` (core/steps.py::maybe_grad_norm).

The predict step is inference end to end on the device: the decoded
forward (eval mode, images cast to the compute dtype; the heads come out
of the f32 final convs and decode in f32), the three scales flattened,
detection confidence = objectness x class probability in f32 ranked by its
best class, corner boxes in f32, then the fixed-shape greedy NMS of
ops/nms.py. It runs under `torch.inference_mode()` on the EMA weights when
the state keeps them (`Trainer.evaluate`'s weights). `evaluate_map` feeds
its outputs to the mAP evaluator (core/eval_detection.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import yolo as yolo_ops
from ..ops.boxes import xywh_to_x1y1x2y2
from ..ops.nms import batched_nms
from ..parallel import mesh
from ..utils.device import to_device, to_host
from .config import UNIT_RANGE_NORM, TrainConfig
from .steps import annotate_step, maybe_grad_norm, normalize_input
from .train_state import TrainState
from .trainer import LossWatchedTrainer

Step = Callable[..., Dict[str, torch.Tensor]]


def boxes_calibration_batch(config: TrainConfig, sample_shape,
                            batch_size: int, seed: int = 0) -> tuple:
    """A seeded (images, boxes, classes, valid) batch of the padded-GT
    layout the YOLO and CenterNet steps share, one box per image: the JAX
    package's grad-calibration batch, bit for bit (the port calibrates
    nothing; its checks run one step on it)."""
    rs = np.random.RandomState(seed)
    b = batch_size
    images = (rs.randint(0, 256, (b, *sample_shape)).astype(np.uint8)
              if config.data.normalize_on_device
              else rs.rand(b, *sample_shape).astype(np.float32))
    boxes = np.zeros((b, yolo_ops.MAX_BOXES, 4), np.float32)
    boxes[:, 0] = [0.2, 0.2, 0.6, 0.6]
    classes = np.zeros((b, yolo_ops.MAX_BOXES), np.int32)
    valid = np.zeros((b, yolo_ops.MAX_BOXES), np.float32)
    valid[:, 0] = 1.0
    return (images, boxes, classes, valid)


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
                         input_norm=None,
                         log_grad_norm: bool = False) -> Step:
    """(state, images, boxes, classes, valid) -> metrics, updating `state`
    in place. boxes: (B, N, 4) normalized corner ground truth padded to
    N = MAX_BOXES; classes (B, N) int; valid (B, N) 0/1. Metrics are device
    scalars: `loss` (the batch mean) and `xy/wh/class/obj_loss`."""

    def step(state: TrainState, images, boxes, classes, valid):
        images = normalize_input(images, input_norm, compute_dtype)
        y_trues = _encode(boxes, classes, valid, num_classes, grid_sizes)
        state.train_model.train()
        outputs = state.train_model(images)
        comp = yolo_ops.yolo_loss(y_trues, outputs, boxes, valid, num_classes)
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

    return annotate_step(step, compute_dtype=compute_dtype, kind="eval")


def predict_candidates(model: torch.nn.Module, images: torch.Tensor,
                       compute_dtype: torch.dtype = torch.bfloat16
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The predict step before NMS: `model`'s decoded eval forward on
    `images` → (corner boxes (B, N, 4), ranking scores (B, N), per-class
    confidences (B, N, C)), all f32, N = 3 · sum of g² over the scales.
    The caller holds the inference mode and the model's eval mode."""
    outputs = model(images.to(compute_dtype), decode=True)
    b = images.shape[0]
    boxes = torch.cat([o[0].reshape(b, -1, 4) for o in outputs], dim=1)
    obj = torch.cat([o[1].reshape(b, -1) for o in outputs], dim=1)
    cls_probs = torch.cat([o[2].reshape(b, -1, o[2].shape[-1])
                           for o in outputs], dim=1)
    # detection confidence = objectness x class probability, the score both
    # the COCO and VOC evaluators rank by; NMS ranks by the best class's
    conf = obj[..., None].float() * cls_probs.float()
    return (xywh_to_x1y1x2y2(boxes.float()), conf.max(dim=-1).values, conf)


def make_predict_step(*, compute_dtype: torch.dtype = torch.bfloat16,
                      iou_thresh: float = 0.5, score_thresh: float = 0.5,
                      max_detection: int = 100) -> Callable:
    """(state, images) → (nms_boxes (B, D, 4), nms_scores (B, D),
    nms_class_probs (B, D, C), counts (B,) int32), on the images' device:
    `predict_candidates` then `batched_nms`, on the state's EMA weights
    when it keeps them."""

    def step(state: TrainState, images: torch.Tensor):
        model = state.model
        with state.ema_weights(), torch.inference_mode():
            model.eval()
            boxes, scores, conf = predict_candidates(model, images,
                                                     compute_dtype)
            return batched_nms(boxes, scores, conf, iou_thresh=iou_thresh,
                               score_thresh=score_thresh,
                               max_detection=max_detection)

    return annotate_step(step, compute_dtype=compute_dtype, kind="predict")


def evaluate_map(state: TrainState, batches: Iterable, *, num_classes: int,
                 metric: str = "coco", iou_thresh: float = 0.5,
                 score_thresh: float = 0.05,
                 compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Detection inference over `batches` of (images, boxes, classes,
    valid[, difficult]) numpy arrays on the state's device, scored by the
    mAP evaluator: metric "coco" → mAP@[.5:.95], "voc" → all-point
    mAP@0.5, "voc07" → 11-point. The low default score threshold keeps the
    precision-recall curve's low-confidence tail, as standard evaluators
    do."""
    from .eval_detection import make_evaluator

    ev = make_evaluator(metric, num_classes)
    predict = make_predict_step(compute_dtype=compute_dtype,
                                iou_thresh=iou_thresh,
                                score_thresh=score_thresh)
    device = next(state.model.parameters()).device
    for batch in batches:
        images, boxes, classes, valid = batch[:4]
        difficult = batch[4] if len(batch) > 4 else None  # VOC devkit flags
        out = predict(state, to_device(images, device))
        ev.add_batch(*(t.cpu().numpy() for t in out), to_host(boxes),
                     to_host(classes), to_host(valid),
                     gt_difficult=(None if difficult is None
                                   else to_host(difficult)))
    return ev.summarize()


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
        self.train_step = make_yolo_train_step(
            **kw, log_grad_norm=config.log_grad_norm)
        self.eval_step = make_yolo_eval_step(**kw)
