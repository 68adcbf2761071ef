"""Train state (own copy of deepvision_tpu/core/train_state.py::TrainState).

The JAX state is a pytree of params, batch_stats, optax state and the
global step. Here the model holds the parameters and the BatchNorm running
statistics, the optimizer holds its moments, its update count, the
accumulated gradients and the plateau's LR scale, and `step` counts the
train steps. The dropout masks of a step are drawn from a generator on the
model's device reseeded from (`seed`, `step`), the counterpart of the JAX
step's `fold_in(rng, state.step)`: they repeat on resume. EMA weights are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import torch

from .optim import Optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    seed: int = 0
    generator: Optional[torch.Generator] = None

    def dropout_generator(self) -> torch.Generator:
        """The generator of this step's dropout masks, seeded from a hash
        of (`seed`, `step`) on the device of the model's parameters (the
        CPU generator keeps only a seed's low 32 bits, so both are mixed
        into all of them)."""
        device = next(self.model.parameters()).device
        if self.generator is None or self.generator.device != device:
            self.generator = torch.Generator(device=device)
        digest = hashlib.blake2b(f"{self.seed}:{self.step}".encode(),
                                 digest_size=8).digest()
        return self.generator.manual_seed(
            int.from_bytes(digest, "little") >> 1)

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
