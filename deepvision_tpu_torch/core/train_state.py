"""Train state (own copy of deepvision_tpu/core/train_state.py::TrainState).

The JAX state is a pytree of params, batch_stats, optax state and the
global step. Here the model holds the parameters and the BatchNorm running
statistics, the optimizer holds the Adam moments, its update count and the
plateau's LR scale, and `step` counts the train steps. EMA weights are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from .optim import AdamChain


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: AdamChain
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
