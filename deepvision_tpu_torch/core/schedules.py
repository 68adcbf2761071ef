"""LR schedules (own copy of deepvision_tpu/core/schedules.py: the
`constant`, `step` and `plateau` schedules the YOLO configs use; warmup,
cosine and linear decay are not ported yet).

A schedule is a function of the optimizer's update count, as an optax
schedule is. Plateau is host-driven: `PlateauState` reacts to the watched
validation metric between epochs, and its scale multiplies the (constant)
base schedule through the optimizer's `lr_scale`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from .config import ScheduleConfig

Schedule = Callable[[int], float]


def build_schedule(cfg: ScheduleConfig, base_lr: float,
                   steps_per_epoch: float) -> Schedule:
    """The LR at update `count` (0-based). `step` multiplies by
    `decay_factor` from each boundary epoch on (boundaries that land on one
    update compound)."""
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
    else:
        raise ValueError(f"schedule {cfg.name!r} is not ported yet "
                         f"(constant, step, plateau)")
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
