"""Classification losses and top-k metrics (own copy of
deepvision_tpu/core/losses.py).

Logits go to f32 (f64 stays f64) before the softmax. Label smoothing is optax's
`smooth_labels`: (1 - a) * onehot + a / K. Top-k follows the JAX package's
`argsort(...)[::-1]`: a stable ascending sort, reversed, so among tied
logits the larger class index comes first.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import torch
import torch.nn.functional as F

Outputs = Union[torch.Tensor, Sequence[torch.Tensor]]


def per_example_xent(logits: torch.Tensor, labels: torch.Tensor,
                     label_smoothing: float = 0.0) -> torch.Tensor:
    """Softmax cross-entropy over integer labels, shape (batch,)."""
    num_classes = logits.shape[-1]
    target = F.one_hot(labels.long(), num_classes).float()
    if label_smoothing:
        target = target * (1.0 - label_smoothing) + label_smoothing / num_classes
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    return -(target * torch.log_softmax(logits, dim=-1)).sum(-1)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    return per_example_xent(logits, labels, label_smoothing).mean()


def classification_loss(outputs: Outputs, labels: torch.Tensor,
                        label_smoothing: float = 0.0,
                        aux_weight: float = 0.3) -> torch.Tensor:
    """Main loss plus `aux_weight` times each auxiliary head's, where
    `outputs` is (main, aux1, ...) as Inception V1 returns in training;
    plain logits otherwise."""
    if isinstance(outputs, (tuple, list)):
        main, *aux = outputs
        loss = softmax_xent(main, labels, label_smoothing)
        for a in aux:
            loss = loss + aux_weight * softmax_xent(a, labels, label_smoothing)
        return loss
    return softmax_xent(outputs, labels, label_smoothing)


def _topk_hits(logits: Outputs, labels: torch.Tensor,
               ks: Sequence[int]) -> Dict[str, torch.Tensor]:
    if isinstance(logits, (tuple, list)):
        logits = logits[0]
    c = logits.shape[-1]
    k_max = min(max(ks), c)
    top = torch.argsort(logits, dim=-1, stable=True).flip(-1)[..., :k_max]
    correct = top == labels.long()[..., None]
    return {f"top{k}": correct[..., :min(k, c)].any(dim=-1) for k in ks}


def topk_accuracies(logits: Outputs, labels: torch.Tensor,
                    ks: Sequence[int] = (1, 5)) -> Dict[str, torch.Tensor]:
    """Top-k accuracy fractions, device scalars."""
    return {k: v.float().mean()
            for k, v in _topk_hits(logits, labels, ks).items()}


def topk_correct(logits: Outputs, labels: torch.Tensor,
                 ks: Sequence[int] = (1, 5)) -> Dict[str, torch.Tensor]:
    """Per-example top-k correctness, 0/1 f32 of shape (batch,), for
    masked evaluation sums."""
    return {k: v.float() for k, v in _topk_hits(logits, labels, ks).items()}
