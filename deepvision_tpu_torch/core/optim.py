"""Optimizer (own copy of deepvision_tpu/core/optim.py: the Adam chain).

The JAX package builds `clip_by_global_norm → scale_by_adam →
scale_by_schedule → scale(-1) → scale(lr_scale)` with optax, and the
host-side plateau writes `lr_scale` between epochs (`set_lr_scale`).
Without weight decay that is `torch.optim.Adam` at lr = schedule(count) ×
lr_scale, which `AdamChain` sets before every update. SGD, RMSprop,
weight decay and gradient accumulation are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

from .config import OptimizerConfig
from .schedules import Schedule


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: when the global L2 norm g of
    `grads` is at least `max_norm`, every gradient becomes t / g * max_norm.
    No host sync: the choice is a tensor op."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    trigger = norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, g / norm.to(g.dtype) * max_norm))


class AdamChain:
    """Adam with the schedule and the plateau's `lr_scale` applied per
    update, and the optional global-norm clip first."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: OptimizerConfig, schedule: Schedule):
        if cfg.name != "adam":
            raise ValueError(f"optimizer {cfg.name!r} is not ported yet "
                             f"(adam)")
        if cfg.weight_decay:
            raise ValueError("weight decay is not ported yet (the Adam "
                             "chain of the YOLO configs has none)")
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.grad_clip_norm = cfg.grad_clip_norm
        self.lr_scale = 1.0
        self.count = 0      # updates applied: the schedule's step count
        self.adam = torch.optim.Adam(self.params, lr=schedule(0),
                                     betas=(cfg.beta1, cfg.beta2),
                                     eps=cfg.eps)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip_norm:
            clip_by_global_norm_(
                [p.grad for p in self.params if p.grad is not None],
                self.grad_clip_norm)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count) * self.lr_scale
        self.adam.step()
        self.count += 1

    def set_lr_scale(self, scale: float) -> None:
        """The plateau's scale (deepvision_tpu/core/optim.py::set_lr_scale)."""
        self.lr_scale = float(scale)

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count,
                "lr_scale": self.lr_scale}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])
        self.lr_scale = float(state["lr_scale"])
