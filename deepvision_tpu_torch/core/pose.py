"""Pose (Stacked Hourglass) steps and trainer (own copy of
deepvision_tpu/core/pose.py: `FOREGROUND_WEIGHT`, `weighted_mse_loss`,
`make_pose_train_step`, `make_pose_eval_step`, `PoseTrainer`).

The labels are rendered on the device inside the step from the raw
(keypoints, visibility) batch (ops/heatmap.py); the loss is the
foreground-weighted MSE of every stack's heatmaps (weight 81 on the
gaussian's pixels, 1 elsewhere), a mean per stack summed over the stacks.
A step is a plain function on device tensors that updates the state in
place; nothing in it waits for the device. Under a process group the
train step runs the state's DDP wrapper on the rank's rows (each rank's
loss is a mean over as many elements, so the mean of the ranks' means is
the global batch's) and returns the global mean. Remat comes with the state (core/remat.py) and
`log_grad_norm` adds the step metric `grad_norm`
(core/steps.py::maybe_grad_norm); the spatial shard_map step of the JAX
package is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.common import at_least_f32
from ..ops.heatmap import render_gaussian_heatmaps
from ..parallel import mesh
from .config import UNIT_RANGE_NORM, TrainConfig
from .steps import annotate_step, maybe_grad_norm, normalize_input
from .train_state import TrainState
from .trainer import LossWatchedTrainer

FOREGROUND_WEIGHT = 81.0  # `Hourglass/tensorflow/train.py:69`

Step = Callable[..., Dict[str, torch.Tensor]]


def weighted_mse_loss(labels: torch.Tensor,
                      outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum over stacks of mean((pred - label)^2 * (81 [label > 0] + 1)),
    in f32 (in f64 for f64 labels or heatmaps)."""
    labels = at_least_f32(labels)
    weights = (labels > 0).to(labels.dtype) * FOREGROUND_WEIGHT + 1.0
    loss = 0.0
    for out in outputs:
        loss = loss + ((labels - at_least_f32(out)) ** 2 * weights).mean()
    return loss


def make_pose_train_step(*, heatmap_size: Tuple[int, int],
                         compute_dtype: torch.dtype = torch.bfloat16,
                         input_norm=None,
                         log_grad_norm: bool = False) -> Step:
    """(state, images, kp_x, kp_y, visibility) -> {"loss"}, updating
    `state` in place. kp_x, kp_y: (B, K) normalized keypoints (< 0:
    missing); visibility (B, K)."""
    h, w = heatmap_size

    def step(state: TrainState, images, kp_x, kp_y, visibility):
        images = normalize_input(images, input_norm, compute_dtype)
        labels = render_gaussian_heatmaps(kp_x, kp_y, visibility, h, w)
        state.train_model.train()
        loss = weighted_mse_loss(labels, state.train_model(images))
        state.optimizer.zero_grad()
        loss.backward()
        norm = maybe_grad_norm(log_grad_norm, state.model.parameters())
        state.optimizer.step()
        state.step += 1
        return mesh.global_means({"loss": loss.detach(), **norm})

    return annotate_step(step, compute_dtype=compute_dtype, kind="train")


def make_pose_eval_step(*, heatmap_size: Tuple[int, int],
                        compute_dtype: torch.dtype = torch.bfloat16,
                        input_norm=None) -> Step:
    """Validation loss step: the running BatchNorm statistics."""
    h, w = heatmap_size

    @torch.no_grad()
    def step(state: TrainState, images, kp_x, kp_y, visibility):
        images = normalize_input(images, input_norm, compute_dtype)
        labels = render_gaussian_heatmaps(kp_x, kp_y, visibility, h, w)
        state.model.eval()
        return {"loss": weighted_mse_loss(labels, state.model(images))}

    return annotate_step(step, compute_dtype=compute_dtype, kind="eval")


class PoseTrainer(LossWatchedTrainer):
    """Hourglass trainer: the shared epoch/checkpoint/plateau machinery with
    the pose steps, watching the validation loss. The model takes the
    config's class count as `num_heatmap` (models/__init__.py)."""

    def __init__(self, config: TrainConfig, *, device=None,
                 workdir: Optional[str] = None,
                 model: Optional[torch.nn.Module] = None):
        super().__init__(config, device=device, workdir=workdir, model=model)
        hm = (config.data.image_size // 4, config.data.image_size // 4)
        kw = dict(heatmap_size=hm, compute_dtype=getattr(torch, config.dtype),
                  input_norm=(UNIT_RANGE_NORM
                              if config.data.normalize_on_device else None))
        self.train_step = make_pose_train_step(
            **kw, log_grad_norm=config.log_grad_norm)
        self.eval_step = make_pose_eval_step(**kw)

    def _calibration_batch(self, sample_shape, batch_size: int,
                           seed: int = 0) -> tuple:
        """A seeded (images, kp_x, kp_y, visibility) batch of the step's
        layout, every joint visible: the JAX trainer's grad-calibration
        batch, bit for bit at the same size (the port calibrates nothing;
        its checks run one step on it)."""
        rs = np.random.RandomState(seed)
        b, k = batch_size, self.config.data.num_classes
        images = (rs.randint(0, 256, (b, *sample_shape)).astype(np.uint8)
                  if self.config.data.normalize_on_device
                  else rs.rand(b, *sample_shape).astype(np.float32))
        kp_x = rs.rand(b, k).astype(np.float32)
        kp_y = rs.rand(b, k).astype(np.float32)
        visibility = np.ones((b, k), np.float32)
        return (images, kp_x, kp_y, visibility)
