"""CenterNet label encoding, losses and decoding on device tensors (own
copy of deepvision_tpu/ops/centernet.py: `gaussian_radius`,
`encode_labels_one`, `encode_labels`, `focal_loss`, `masked_l1_loss`,
`centernet_loss`, `decode`).

- labels: per-class centre heatmaps splatted with size-adaptive gaussians
  (CornerNet's radius at min_overlap 0.7), and the size (in output-stride
  pixels), centre offset and mask at each object's centre cell;
- losses: the penalty-reduced pixelwise focal loss (alpha 2, beta 4) on
  the heatmap, masked L1 on size (x0.1) and offset (x1), summed over the
  stacks, per example, in f32 (in f64 for an f64 model's heads, the
  reference of the card's checks);
- decode: peaks where the sigmoid equals its 3x3 max (padded with -inf),
  then the top K scores.

Tensors are NHWC, as the model returns them. The JAX package vmaps one
example; here the batch is a dimension written out. Two index semantics
of the JAX scatters and top-k are made explicit and deterministic on
every device:
- the class splat is a scatter-max (order-free); a box that is invalid,
  or whose class lies outside [-C, C), writes nothing (a class in
  [-C, 0) wraps, as JAX indexes);
- the size, offset and mask of a centre cell come from the LAST valid box
  that lands there, as `.at[gy, gx].set(mode="drop")` gives on the CPU: a
  scatter-max of the box index per cell picks the writer, the rest write
  to one spare row that is cut off. A cell index in [-g, 0) wraps to
  g + index, one outside [-g, g) drops (a centre at exactly 1.0 falls on
  cell g: dropped);
- top-k breaks ties by the lower flat index, as `jax.lax.top_k` does:
  a stable descending sort of the scores (torch.topk promises no order
  among equal values).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.common import at_least_f32

SIZE_LOSS_WEIGHT = 0.1
OFFSET_LOSS_WEIGHT = 1.0


def gaussian_radius(height: torch.Tensor, width: torch.Tensor,
                    min_overlap: float = 0.7) -> torch.Tensor:
    """CornerNet's radius: the largest r such that a corner shifted by r
    still gives IoU >= min_overlap; elementwise over box sizes in output
    pixels."""
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = torch.sqrt(torch.clamp(b1 ** 2 - 4 * a1 * c1, min=0.0))
    r1 = (b1 - sq1) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = torch.sqrt(torch.clamp(b2 ** 2 - 4 * a2 * c2, min=0.0))
    r2 = (b2 - sq2) / (2 * a2)

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))
    r3 = (b3 + sq3) / (2 * a3)
    return torch.clamp(torch.minimum(torch.minimum(r1, r2), r3), min=0.0)


def _wrap(index: torch.Tensor, size: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(index wrapped from [-size, 0) to [0, size), whether it is in
    [-size, size)): JAX's normalization of a negative scatter index."""
    inside = (index >= -size) & (index < size)
    return torch.remainder(index, size), inside


def encode_labels(boxes: torch.Tensor, classes: torch.Tensor,
                  valid: torch.Tensor, grid: int,
                  num_classes: int) -> Dict[str, torch.Tensor]:
    """Padded corner boxes (B, N, 4) normalized, classes (B, N), valid
    (B, N) 0/1 -> {"heatmap" (B, g, g, C), "size" (B, g, g, 2), "offset"
    (B, g, g, 2), "mask" (B, g, g)}, all f32 (f64 from f64 boxes)."""
    b, n, _ = boxes.shape
    dev = boxes.device
    boxes = at_least_f32(boxes)
    dt = boxes.dtype
    ok = valid != 0
    center = (boxes[..., 0:2] + boxes[..., 2:4]) / 2.0 * grid   # (B,N,2) x,y
    wh = (boxes[..., 2:4] - boxes[..., 0:2]) * grid
    cell = torch.floor(center)                                  # (B,N,2)

    radius = torch.clamp(gaussian_radius(wh[..., 1], wh[..., 0]), min=1e-2)
    sigma = radius / 3.0
    xs = torch.arange(grid, dtype=dt, device=dev)
    dx = xs - cell[..., 0, None]                                 # (B,N,g)
    dy = xs - cell[..., 1, None]
    g2 = dx[..., None, :] ** 2 + dy[..., :, None] ** 2           # (B,N,y,x)
    gauss = torch.exp(-g2 / (2.0 * sigma[..., None, None] ** 2))
    gauss = torch.where(ok[..., None, None], gauss, torch.zeros((),
                                                                device=dev))

    # the per-class scatter-max: classes out of range go to a spare channel
    cls, cls_in = _wrap(classes.long(), num_classes)
    cls = torch.where(ok & cls_in, cls, num_classes)
    heatmap = torch.zeros((b, num_classes + 1, grid * grid), dtype=dt,
                          device=dev)
    heatmap.scatter_reduce_(1, cls[..., None].expand(b, n, grid * grid),
                            gauss.reshape(b, n, grid * grid), reduce="amax")
    heatmap = heatmap[:, :num_classes].reshape(b, num_classes, grid, grid)

    # size / offset / mask: the last valid box of each cell writes
    cell_i = cell.long()
    gx, gx_in = _wrap(cell_i[..., 0], grid)
    gy, gy_in = _wrap(cell_i[..., 1], grid)
    write = ok & gx_in & gy_in
    image = torch.arange(b, device=dev)[:, None]
    spare = b * grid * grid
    target = torch.where(write, (image * grid + gy) * grid + gx,
                         spare).flatten()
    order = torch.arange(n, device=dev).repeat(b)
    winner = torch.full((spare + 1,), -1, dtype=torch.long, device=dev)
    winner.scatter_reduce_(0, target, order, reduce="amax")
    target = torch.where(winner[target] == order, target, spare)
    updates = torch.cat([wh, center - cell, torch.ones_like(wh[..., :1])],
                        dim=-1).reshape(-1, 5)
    dense = torch.zeros((spare + 1, 5), dtype=dt, device=dev)
    dense.index_put_((target,), updates)   # repeats only on the spare row
    dense = dense[:spare].view(b, grid, grid, 5)
    return {"heatmap": heatmap.permute(0, 2, 3, 1),
            "size": dense[..., 0:2], "offset": dense[..., 2:4],
            "mask": dense[..., 4]}


def encode_labels_one(boxes: torch.Tensor, classes: torch.Tensor,
                      valid: torch.Tensor, grid: int,
                      num_classes: int) -> Dict[str, torch.Tensor]:
    """One example: (N, 4), (N,), (N,) -> targets without the batch dim."""
    out = encode_labels(boxes[None], classes[None], valid[None], grid,
                        num_classes)
    return {k: v[0] for k, v in out.items()}


def focal_loss(pred_logits: torch.Tensor,
               target: torch.Tensor) -> torch.Tensor:
    """Penalty-reduced pixelwise focal loss (paper eq. 1) per example (B,),
    normalized by the number of centres (target == 1), at least 1."""
    p = torch.clamp(torch.sigmoid(at_least_f32(pred_logits)), 1e-6,
                    1.0 - 1e-6)
    pos = (target >= 1.0 - 1e-6).float()
    pos_loss = pos * (1 - p) ** 2 * torch.log(p)
    neg_loss = (1 - pos) * (1 - target) ** 4 * p ** 2 * torch.log(1 - p)
    s = (pos_loss + neg_loss).sum(dim=(1, 2, 3))
    n_pos = pos.sum(dim=(1, 2, 3))
    return -s / torch.clamp(n_pos, min=1.0)


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """L1 at the centre cells only, per example (B,), normalized by the
    centre count (at least 1)."""
    diff = ((at_least_f32(pred) - target).abs() * mask[..., None]).sum(
        dim=(1, 2, 3))
    return diff / torch.clamp(mask.sum(dim=(1, 2)), min=1.0)


def centernet_loss(outputs: Sequence[Dict[str, torch.Tensor]],
                   targets: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Per-stack losses summed (intermediate supervision) -> {"heatmap",
    "size", "offset", "total"}, each (B,)."""
    hm = size = off = 0.0
    for out in outputs:
        hm = hm + focal_loss(out["heatmap"], targets["heatmap"])
        size = size + masked_l1_loss(out["size"], targets["size"],
                                     targets["mask"])
        off = off + masked_l1_loss(out["offset"], targets["offset"],
                                   targets["mask"])
    total = hm + SIZE_LOSS_WEIGHT * size + OFFSET_LOSS_WEIGHT * off
    return {"heatmap": hm, "size": size, "offset": off, "total": total}


def top_k_lowest_index(scores: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row of (B, M) `scores`, descending, equal
    scores in ascending index order (`jax.lax.top_k`'s order)."""
    values, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def decode(head: Dict[str, torch.Tensor], *, max_detections: int = 100
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Peaks -> detections. head: {"heatmap" (B, g, g, C) logits, "size"
    (B, g, g, 2), "offset" (B, g, g, 2)} -> (boxes (B, K, 4) normalized
    corners, scores (B, K) descending, classes (B, K) int32)."""
    # the sigmoid scores kept where they equal their 3x3 neighbourhood's
    # max (max_pool2d pads with -inf), 0 elsewhere
    hm = torch.sigmoid(head["heatmap"].float())
    peak = F.max_pool2d(hm.permute(0, 3, 1, 2), 3, stride=1,
                        padding=1).permute(0, 2, 3, 1)
    hm = torch.where(hm == peak, hm, torch.zeros((), device=hm.device))
    b, g, _, num_classes = hm.shape
    scores, idx = top_k_lowest_index(hm.reshape(b, -1), max_detections)
    cls = (idx % num_classes).to(torch.int32)
    cell = torch.div(idx, num_classes, rounding_mode="floor")
    cy = torch.div(cell, g, rounding_mode="floor")
    cx = cell % g

    def take(m: torch.Tensor) -> torch.Tensor:      # (B, g, g, 2) at cells
        flat = m.float().reshape(b, g * g, 2)
        return torch.gather(flat, 1, cell[..., None].expand(-1, -1, 2))

    off, wh = take(head["offset"]), take(head["size"])
    px = cx.float() + off[..., 0]
    py = cy.float() + off[..., 1]
    boxes = torch.stack([(px - wh[..., 0] / 2) / g, (py - wh[..., 1] / 2) / g,
                         (px + wh[..., 0] / 2) / g, (py + wh[..., 1] / 2) / g],
                        dim=-1)
    return boxes, scores, cls
