"""YOLO V3 box coding, on-device label encoding and loss (own copy of
deepvision_tpu/ops/yolo.py).

Label encoding runs on the device inside the train step, over a fixed
`MAX_BOXES` ground-truth pad, as one scatter per scale — no per-example
Python. The JAX package vmaps a per-example scatter; here the batch is a
dimension written out. The ignore mask takes IoU against the padded
ground-truth list through `ops/best_iou.best_iou` (the CUDA kernel on the
card). BCE terms work on logits.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .best_iou import best_iou
from .boxes import xywh_to_x1y1x2y2

# The 9 COCO anchors, normalized by the 416 training resolution. Groups of 3
# per scale: [0:3] → stride 8, [3:6] → 16, [6:9] → 32.
ANCHORS_WH = torch.tensor([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                           [59, 119], [116, 90], [156, 198], [373, 326]],
                          dtype=torch.float32) / 416.0

MAX_BOXES = 100  # ground-truth pad

LAMBDA_COORD = 5.0
LAMBDA_NOOBJ = 0.5
IGNORE_THRESH = 0.5


def _anchors(anchors_wh, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(ANCHORS_WH if anchors_wh is None else anchors_wh,
                           dtype=like.dtype, device=like.device)


def _cell_offsets(grid_size: int, device) -> torch.Tensor:
    """(g, g, 1, 2) f32 cell offsets: row y, column x, offsets[y, x] ==
    (x, y)."""
    r = torch.arange(grid_size, dtype=torch.float32, device=device)
    cy, cx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([cx, cy], dim=-1)[:, :, None, :]


def decode_boxes(y_pred: torch.Tensor, anchors_wh, num_classes: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw head output (..., g, g, 3, 5 + C) → (box_xywh (..., 4) absolute
    normalized, objectness (..., 1), classes (..., C)), the last two
    sigmoided. bx = (sigmoid(tx) + Cx) / g, bw = exp(tw) * pw."""
    grid_size = y_pred.shape[-4]
    c_xy = _cell_offsets(grid_size, y_pred.device)
    b_xy = (torch.sigmoid(y_pred[..., 0:2]) + c_xy) / float(grid_size)
    b_wh = torch.exp(y_pred[..., 2:4]) * _anchors(anchors_wh, y_pred)
    objectness = torch.sigmoid(y_pred[..., 4:5])
    classes = torch.sigmoid(y_pred[..., 5:5 + num_classes])
    return torch.cat([b_xy, b_wh], dim=-1), objectness, classes


def encode_boxes(y_true_xywh: torch.Tensor, anchors_wh) -> torch.Tensor:
    """Absolute normalized (bx, by, bw, bh) → cell-relative (tx, ty, tw,
    th), the inverse of `decode_boxes`; empty cells (w = 0) give tw = 0."""
    grid_size = y_true_xywh.shape[-4]
    c_xy = _cell_offsets(grid_size, y_true_xywh.device)
    t_xy = y_true_xywh[..., 0:2] * float(grid_size) - c_xy
    raw = y_true_xywh[..., 2:4] / _anchors(anchors_wh, y_true_xywh)
    t_wh = torch.where(raw > 0, torch.log(torch.clamp(raw, min=1e-12)),
                       torch.zeros_like(raw))
    return torch.cat([t_xy, t_wh], dim=-1)


def find_best_anchor(boxes_x1y1x2y2: torch.Tensor,
                     anchors_wh=None) -> torch.Tensor:
    """Best of the 9 anchors per box by centered IoU: (..., 4) corner boxes
    → (...) int64 anchor indices in [0, 9), the first on a tie."""
    anchors = _anchors(anchors_wh, boxes_x1y1x2y2)
    box_wh = boxes_x1y1x2y2[..., 2:4] - boxes_x1y1x2y2[..., 0:2]
    inter = (torch.minimum(box_wh[..., None, 0], anchors[:, 0])
             * torch.minimum(box_wh[..., None, 1], anchors[:, 1]))
    box_area = box_wh[..., 0] * box_wh[..., 1]
    anchor_area = anchors[:, 0] * anchors[:, 1]
    iou = inter / (box_area[..., None] + anchor_area - inter + 1e-12)
    return torch.argmax(iou, dim=-1)


def encode_labels_one_scale(classes_onehot: torch.Tensor, boxes: torch.Tensor,
                            valid: torch.Tensor, grid_size: int,
                            scale_index: int, anchors_wh=None) -> torch.Tensor:
    """Dense (B, g, g, 3, 5 + C) target of one scale from padded ground
    truth: classes_onehot (B, N, C), boxes (B, N, 4) corner boxes, valid
    (B, N) 0/1. A box lands in cell [gy][gx], anchor a, iff it is valid and
    its best anchor belongs to this scale; the cell holds (cx, cy, w, h, 1,
    one-hot).

    Index semantics are the JAX package's `.at[gy, gx, a].set(mode="drop")`
    on the CPU: a cell index in [-g, 0) wraps to g + index, one outside
    [-g, g) is dropped, and when several boxes land on one target the last
    valid one wins. That is made deterministic here (the card's index_put_
    would pick any writer): per target only the highest box index is
    written; the others go to one spare row that is cut off at the end."""
    b, n, c = classes_onehot.shape
    g = grid_size
    anchor_idx = find_best_anchor(boxes, anchors_wh)
    box_xy = (boxes[..., 0:2] + boxes[..., 2:4]) / 2.0
    box_wh = boxes[..., 2:4] - boxes[..., 0:2]
    cell = torch.floor(box_xy * g).long()                 # (B, N, 2) = (gx, gy)
    ok = ((valid != 0) & (anchor_idx // 3 == scale_index)
          & ((cell >= -g) & (cell < g)).all(dim=-1))
    cell = torch.remainder(cell, g)
    image = torch.arange(b, device=boxes.device)[:, None]
    target = ((image * g + cell[..., 1]) * g + cell[..., 0]) * 3 \
        + anchor_idx % 3                                  # (B, N)
    spare = b * g * g * 3
    target = torch.where(ok, target, spare).flatten()
    order = torch.arange(n, device=boxes.device).repeat(b)
    winner = torch.full((spare + 1,), -1, dtype=torch.long,
                        device=boxes.device)
    winner.scatter_reduce_(0, target, order, reduce="amax")
    target = torch.where(winner[target] == order, target, spare)
    updates = torch.cat([box_xy, box_wh, torch.ones_like(box_xy[..., :1]),
                         classes_onehot.float()], dim=-1).reshape(-1, 5 + c)
    y = torch.zeros((spare + 1, 5 + c), dtype=torch.float32,
                    device=boxes.device)
    y.index_put_((target,), updates.float())  # repeats only on the spare row
    return y[:spare].view(b, g, g, 3, 5 + c)


def encode_labels(classes_onehot: torch.Tensor, boxes: torch.Tensor,
                  valid: torch.Tensor, grid_sizes: Sequence[int],
                  anchors_wh=None) -> Tuple[torch.Tensor, ...]:
    """Per-scale dense labels of a batch, ordered like the model outputs:
    finest grid (stride 8) first."""
    return tuple(encode_labels_one_scale(classes_onehot, boxes, valid, g, i,
                                         anchors_wh)
                 for i, g in enumerate(grid_sizes))


def yolo_loss_one_scale(y_true: torch.Tensor, y_pred: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                        scale_anchors_wh, num_classes: int
                        ) -> Dict[str, torch.Tensor]:
    """Per-example YOLO loss of one scale, in f32 whatever the heads' dtype.

    y_true: (B, g, g, 3, 5 + C) dense targets (absolute xywh, obj, one-hot);
    y_pred: (B, g, g, 3, 5 + C) raw logits; gt_boxes (B, N, 4) corner
    ground truth and gt_valid (B, N) for the ignore mask. Returns (B,)
    components: xy, wh, class, obj, total."""
    anchors = torch.as_tensor(scale_anchors_wh, dtype=torch.float32,
                              device=y_pred.device)
    y_pred = y_pred.float()
    y_true = y_true.float()

    pred_xy_rel = torch.sigmoid(y_pred[..., 0:2])
    pred_wh_rel = y_pred[..., 2:4]
    pred_box_abs, _, _ = decode_boxes(y_pred, anchors, num_classes)
    pred_box_corners = xywh_to_x1y1x2y2(pred_box_abs)

    true_obj = y_true[..., 4:5]
    true_class = y_true[..., 5:]
    true_box_rel = encode_boxes(y_true[..., 0:4], anchors)
    true_xy_rel = true_box_rel[..., 0:2]
    true_wh_rel = true_box_rel[..., 2:4]

    # small-box weighting 2 - w*h
    weight = 2.0 - y_true[..., 2] * y_true[..., 3]
    obj = true_obj[..., 0]

    xy_loss = torch.sum(torch.square(true_xy_rel - pred_xy_rel), dim=-1)
    xy_loss = torch.sum(obj * weight * xy_loss, dim=(1, 2, 3)) * LAMBDA_COORD
    wh_loss = torch.sum(torch.square(true_wh_rel - pred_wh_rel), dim=-1)
    wh_loss = torch.sum(obj * weight * wh_loss, dim=(1, 2, 3)) * LAMBDA_COORD

    # elementwise sigmoid BCE on logits: optax.sigmoid_binary_cross_entropy
    class_bce = F.binary_cross_entropy_with_logits(
        y_pred[..., 5:], true_class, reduction="none")
    class_loss = torch.sum(true_obj * class_bce, dim=(1, 2, 3, 4))

    # ignore mask: predictions that overlap ANY valid ground truth by more
    # than IGNORE_THRESH are not penalized for objectness. Padded GT rows
    # are zeroed (zero area → IoU 0). The mask is consumed through a `<`,
    # so it has no gradient: best_iou takes detached inputs (the JAX
    # package's stop_gradient).
    b, g = y_pred.shape[0], y_pred.shape[1]
    flat_pred = pred_box_corners.detach().reshape(b, -1, 4)
    masked_gt = gt_boxes.float() * gt_valid[..., None].float()
    best = best_iou(flat_pred, masked_gt).reshape(b, g, g, 3)
    ignore_mask = (best < IGNORE_THRESH).float()[..., None]

    obj_bce = F.binary_cross_entropy_with_logits(
        y_pred[..., 4:5], true_obj, reduction="none")
    obj_term = torch.sum(true_obj * obj_bce, dim=(1, 2, 3, 4))
    noobj_term = torch.sum((1.0 - true_obj) * obj_bce * ignore_mask,
                           dim=(1, 2, 3, 4)) * LAMBDA_NOOBJ
    obj_loss = obj_term + noobj_term

    total = xy_loss + wh_loss + class_loss + obj_loss
    return {"xy": xy_loss, "wh": wh_loss, "class": class_loss,
            "obj": obj_loss, "total": total}


def yolo_loss(y_trues: Sequence[torch.Tensor], y_preds: Sequence[torch.Tensor],
              gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
              num_classes: int,
              anchors_wh: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
    """Sum of the per-scale losses over the 3 scales, finest (anchors 0-2)
    first. Returns (B,) per-example components."""
    anchors = ANCHORS_WH if anchors_wh is None else torch.as_tensor(anchors_wh)
    out: Optional[Dict[str, torch.Tensor]] = None
    for i, (y_true, y_pred) in enumerate(zip(y_trues, y_preds)):
        part = yolo_loss_one_scale(y_true, y_pred, gt_boxes, gt_valid,
                                   anchors[3 * i:3 * i + 3], num_classes)
        out = part if out is None else {k: out[k] + part[k] for k in out}
    return out
