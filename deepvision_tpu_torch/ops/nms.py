"""Fixed-shape greedy non-maximum suppression (own copy of
deepvision_tpu/ops/nms.py: `batched_nms`).

The JAX package runs a `lax.fori_loop` of `max_detection` picks per image
under `vmap`; here the batch is a tensor dimension and the loop runs on
the host, `max_detection` iterations of a few tensor ops each, with no
host synchronisation inside it (no `.item()`, no early exit when nothing
survives: an iteration without a survivor records an invalid pick, as
the JAX loop does). Each iteration picks, per image, the highest score
still alive (`torch.max` over a dimension returns the first maximal
index, as `jnp.argmax` does, so ties break by index), then kills the
pick and every box whose IoU with it is above `iou_thresh` (`>`: a box at
exactly the threshold survives). The picks are gathered once at the end;
invalid rows are zero.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .boxes import broadcast_iou


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, *, iou_thresh: float = 0.5,
                score_thresh: float = 0.5, max_detection: int = 100
                ) -> Tuple[torch.Tensor, ...]:
    """Greedy NMS of (B, N, 4) corner boxes, (B, N) scores and (B, N, C)
    per-class probabilities → (boxes (B, D, 4), scores (B, D),
    class_probs (B, D, C), valid_counts (B,) int32), D = max_detection,
    picks in descending score order, zero rows past each image's count."""
    b, n = scores.shape
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    # a dead candidate's score is -inf: the masked scores ARE the alive set
    masked = torch.where(scores >= score_thresh, scores, neg_inf)
    index = torch.arange(n, device=scores.device)
    picks, valids = [], []
    for _ in range(max_detection):
        best_score, best = masked.max(dim=1)                    # (B,)
        valid = best_score > neg_inf                            # survivor?
        best_box = boxes.gather(1, best[:, None, None].expand(b, 1, 4))
        iou = broadcast_iou(best_box, boxes)[:, 0]              # (B, N)
        kill = (iou > iou_thresh) | (index == best[:, None])
        masked = masked.masked_fill(kill & valid[:, None], float("-inf"))
        picks.append(best)
        valids.append(valid)
    pick = torch.stack(picks, dim=1)                            # (B, D)
    valid = torch.stack(valids, dim=1)

    def take(t: torch.Tensor) -> torch.Tensor:
        rows = t.gather(1, pick.view(b, -1, *[1] * (t.dim() - 2)).expand(
            b, max_detection, *t.shape[2:]))
        return torch.where(valid.view(b, -1, *[1] * (t.dim() - 2)), rows,
                           torch.zeros((), dtype=t.dtype, device=t.device))

    return (take(boxes), take(scores), take(classes),
            valid.sum(dim=1, dtype=torch.int32))
