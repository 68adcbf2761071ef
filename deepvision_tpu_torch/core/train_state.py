"""Train state (own copy of deepvision_tpu/core/train_state.py: `TrainState`
with its EMA of the parameters; `ema_tree_update` is `ema_update_`).

The JAX state is a pytree of params, batch_stats, optax state, the global
step and the EMA params. Here the model holds the parameters and the
BatchNorm running statistics, the optimizer holds its moments, its update
count, the accumulated gradients and the plateau's LR scale, `step` counts
the train steps, and `ema` (when enabled) holds the Polyak average of the
parameters only: as in the JAX package, evaluation pairs the EMA
parameters with the *current* BatchNorm statistics.

The random draws of a step (dropout masks, device augmentation) come from
generators on the model's device reseeded from (`seed`, `step`) and a
stream tag, the counterpart of the JAX step's `fold_in(rng, state.step)`:
they repeat on resume.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Dict, Iterator, List, Optional

import torch

from .optim import Optimizer


@torch.no_grad()
def ema_update_(ema: List[torch.Tensor], params: List[torch.Tensor],
                decay: float) -> None:
    """ema = ema * d + (1 - d) * params in place, in the JAX package's
    order of roundings (each product rounded, then the sum; `lerp_` rounds
    otherwise)."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    seed: int = 0
    #: the EMA's decay; None keeps no average
    ema_decay: Optional[float] = None
    #: the EMA of `model.parameters()`, in their order
    ema: Optional[List[torch.Tensor]] = None
    generators: Dict[str, torch.Generator] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if self.ema_decay is not None and self.ema is None:
            self.ema = [p.detach().clone() for p in self.model.parameters()]

    def step_generator(self, stream: str = "") -> torch.Generator:
        """The generator of this step's draws on `stream` ("" for dropout,
        "augment" for the device augmentation), seeded from a hash of
        (`seed`, `step`, `stream`) on the device of the model's parameters
        (the CPU generator keeps only a seed's low 32 bits, so all of them
        are mixed into all of its bits)."""
        device = next(self.model.parameters()).device
        gen = self.generators.get(stream)
        if gen is None or gen.device != device:
            gen = self.generators[stream] = torch.Generator(device=device)
        key = f"{self.seed}:{self.step}" + (f":{stream}" if stream else "")
        digest = hashlib.blake2b(key.encode(), digest_size=8).digest()
        return gen.manual_seed(int.from_bytes(digest, "little") >> 1)

    def dropout_generator(self) -> torch.Generator:
        """The generator of this step's dropout masks."""
        return self.step_generator()

    def update_ema(self) -> None:
        """One Polyak step of the EMA toward the current parameters."""
        ema_update_(self.ema, [p.detach() for p in self.model.parameters()],
                    self.ema_decay)

    @contextlib.contextmanager
    def ema_weights(self) -> Iterator[None]:
        """The EMA parameters swapped into the model (no copy) for the
        body, then swapped back; nothing when there is no EMA."""
        if self.ema is None:
            yield
            return
        params = list(self.model.parameters())

        def swap():
            for p, e in zip(params, self.ema):
                p.data, e.data = e.data, p.data

        swap()
        try:
            yield
        finally:
            swap()

    def state_dict(self) -> dict:
        names = [n for n, _ in self.model.named_parameters()]
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step,
                "ema": (None if self.ema is None
                        else dict(zip(names, self.ema)))}

    def load_state_dict(self, state: dict) -> None:
        """Restores the model, optimizer, step and the EMA. A checkpoint
        without an EMA starts one from the restored parameters when this
        state keeps one; a checkpoint's EMA is restored even when this
        state keeps none (the trainer decides what to do with it)."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        saved = state.get("ema")
        named = list(self.model.named_parameters())
        if saved is not None:
            self.ema = [saved[n].to(p.device, p.dtype) for n, p in named]
        elif self.ema_decay is not None:
            self.ema = [p.detach().clone() for _, p in named]
        else:
            self.ema = None


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
