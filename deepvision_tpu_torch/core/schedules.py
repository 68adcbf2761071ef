"""LR schedules (own copy of deepvision_tpu/core/schedules.py).

A schedule is a function of the optimizer's update count, as an optax
schedule is: `constant`, `step`, `cosine` (optax's cosine_decay_schedule
with alpha = min_lr / base_lr), `linear_decay` (constant until
`decay_start_epoch`, then linear to 0) and `plateau`, each optionally under
a multiplicative linear warmup. Plateau is host-driven: `PlateauState`
reacts to the watched validation metric between epochs, and its scale
multiplies the (constant) base schedule through the optimizer's `lr_scale`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

from .config import ScheduleConfig

Schedule = Callable[[int], float]


def build_schedule(cfg: ScheduleConfig, base_lr: float,
                   steps_per_epoch: float, total_epochs: int) -> Schedule:
    """The LR at update `count` (0-based). `steps_per_epoch` may be
    fractional (updates per epoch under gradient accumulation): every epoch
    is multiplied into steps first, then truncated. `step` multiplies by
    `decay_factor` from each boundary epoch on (boundaries that land on one
    update compound)."""
    warmup_steps = int(cfg.warmup_epochs * steps_per_epoch)
    total_steps = max(1, int(total_epochs * steps_per_epoch))
    if cfg.name in ("constant", "plateau"):
        def base(count: int) -> float:
            return base_lr
    elif cfg.name == "step":
        boundaries: Dict[int, float] = {}
        for e in cfg.boundaries_epochs:
            k = int(e * steps_per_epoch)
            boundaries[k] = boundaries.get(k, 1.0) * cfg.decay_factor

        def base(count: int) -> float:
            lr = base_lr
            for k, factor in boundaries.items():
                if count >= k:
                    lr *= factor
            return lr
    elif cfg.name == "cosine":
        alpha = cfg.min_lr / base_lr if base_lr else 0.0

        def base(count: int) -> float:
            t = min(count, total_steps)
            decay = 0.5 * (1 + math.cos(math.pi * t / total_steps))
            return base_lr * ((1 - alpha) * decay + alpha)
    elif cfg.name == "linear_decay":
        decay_start = int(cfg.decay_start_epoch * steps_per_epoch)
        span = max(1, total_steps - decay_start)

        def base(count: int) -> float:
            if count < decay_start:
                return base_lr
            return base_lr * (1 - min(count - decay_start, span) / span)
    else:
        raise ValueError(f"unknown schedule {cfg.name!r}")

    if warmup_steps > 0:
        # multiplicative, so the base schedule's boundaries stay at their
        # absolute steps
        def warmed(count: int) -> float:
            return base(count) * min(1.0, (count + 1) / warmup_steps)
        return warmed
    return base


@dataclasses.dataclass
class PlateauState:
    """Host-side ReduceLROnPlateau: when the watched metric has not improved
    for more than `patience` epochs, multiply the LR scale by `factor`."""
    patience: int = 2
    factor: float = 0.1
    mode: str = "max"
    min_scale: float = 0.0
    best: Optional[float] = None
    num_bad_epochs: int = 0
    scale: float = 1.0

    def update(self, metric: float) -> float:
        improved = (
            self.best is None
            or (self.mode == "max" and metric > self.best)
            or (self.mode == "min" and metric < self.best)
        )
        if improved:
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.num_bad_epochs = 0
        return self.scale
