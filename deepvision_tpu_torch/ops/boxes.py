"""Box geometry shared by the detection families (own copy of
deepvision_tpu/ops/boxes.py): corner/center converters and the pairwise
IoU. Boxes are normalized coordinates in the last axis.
"""

from __future__ import annotations

import torch


def xywh_to_x1y1x2y2(box: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) → (xmin, ymin, xmax, ymax)."""
    xy, wh = box[..., 0:2], box[..., 2:4]
    return torch.cat([xy - wh / 2.0, xy + wh / 2.0], dim=-1)


def xywh_to_y1x1y2x2(box: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) → (ymin, xmin, ymax, xmax), the tf.image order."""
    yx = torch.cat([box[..., 1:2], box[..., 0:1]], dim=-1)
    hw = torch.cat([box[..., 3:4], box[..., 2:3]], dim=-1)
    return torch.cat([yx - hw / 2.0, yx + hw / 2.0], dim=-1)


def x1y1x2y2_to_xywh(box: torch.Tensor) -> torch.Tensor:
    """(xmin, ymin, xmax, ymax) → (cx, cy, w, h)."""
    xy = (box[..., 0:2] + box[..., 2:4]) / 2.0
    wh = box[..., 2:4] - box[..., 0:2]
    return torch.cat([xy, wh], dim=-1)


def broadcast_iou(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) and (..., M, 4) corner boxes → (..., N, M):
    overlap width and height clipped to [0, 1], union + 1e-7."""
    a = box_a[..., :, None, :]
    b = box_b[..., None, :, :]
    left = torch.maximum(a[..., 0], b[..., 0])
    top = torch.maximum(a[..., 1], b[..., 1])
    right = torch.minimum(a[..., 2], b[..., 2])
    bot = torch.minimum(a[..., 3], b[..., 3])
    iw = torch.clamp(right - left, 0.0, 1.0)
    ih = torch.clamp(bot - top, 0.0, 1.0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + 1e-7)
