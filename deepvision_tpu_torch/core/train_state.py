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
they repeat on resume. The host draws of a step (mixup and CutMix's lam,
permutation and box, core/steps.py) come from a numpy generator seeded
from the same hash (`step_numpy_rng`).

With `remat` the train forward runs through `core/remat.py::Remat`, its
activations recomputed in the backward.

Under a process group (parallel/mesh.py) the train steps run `train_model`,
the model wrapped in `DistributedDataParallel`, which broadcasts rank 0's
weights when it wraps and averages the gradients over the ranks in the
backward. Evaluation, the EMA and the checkpoints use the unwrapped
`model`, so a checkpoint is the same whatever the world size. Each rank
draws its own dropout masks and augmentation: the rank joins the seed of
the step's generators, and rank 0 draws the one-process stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import inspect
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..parallel import mesh
from .optim import Optimizer
from .remat import Remat


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
    #: recompute the train forward's activations in the backward
    remat: bool = False

    #: the model wrapped for data parallelism under a process group
    ddp: Optional[torch.nn.Module] = dataclasses.field(default=None,
                                                       init=False)
    #: the model or its `Remat` wrapper: what DDP wraps
    _forward: Optional[torch.nn.Module] = dataclasses.field(default=None,
                                                            init=False)

    def __post_init__(self):
        if self.ema_decay is not None and self.ema is None:
            self.ema = [p.detach().clone() for p in self.model.parameters()]
        self._forward = Remat(self.model) if self.remat else self.model
        if mesh.is_initialized():
            self.ddp = wrap_ddp(self._forward)

    @property
    def train_model(self) -> torch.nn.Module:
        """What a train step runs: the DDP wrapper under a process group,
        else the model (each through `Remat` under `remat`)."""
        return self._forward if self.ddp is None else self.ddp

    def step_generator(self, stream: str = "") -> torch.Generator:
        """The generator of this step's draws on `stream` ("" for dropout,
        "augment" for the device augmentation), seeded from a hash of
        (`seed`, `step`, `stream`, the rank; rank 0 and a run without a
        process group hash the first three alone) on the device of the
        model's parameters (the CPU generator keeps only a seed's low 32
        bits, so all of them are mixed into all of its bits)."""
        device = next(self.model.parameters()).device
        gen = self.generators.get(stream)
        if gen is None or gen.device != device:
            gen = self.generators[stream] = torch.Generator(device=device)
        return gen.manual_seed(self._stream_seed(stream))

    def step_numpy_rng(self, stream: str) -> np.random.Generator:
        """A host generator of this step's draws on `stream`, seeded from
        the hash `step_generator` uses: the draws repeat per (seed, step,
        stream, rank) and reach the card without a device sync."""
        return np.random.default_rng(self._stream_seed(stream))

    def _stream_seed(self, stream: str) -> int:
        key = (f"{self.seed}:{self.step}" + (f":{stream}" if stream else "")
               + (f"@{mesh.rank()}" if mesh.rank() else ""))
        digest = hashlib.blake2b(key.encode(), digest_size=8).digest()
        return int.from_bytes(digest, "little") >> 1

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


def wrap_ddp(model: torch.nn.Module) -> torch.nn.Module:
    """`model` (already on its device) in `DistributedDataParallel` over
    the default group, rank 0's weights broadcast. The buffers are not
    broadcast at each forward: the BatchNorm statistics come out of the
    global batch equal on every rank (PyTorch releases that deprecate
    `broadcast_buffers` name this `forward_sync_buffers`). No config
    leaves a parameter out of its train forward, so DDP looks for none
    (it raises if a model ever does)."""
    ddp = torch.nn.parallel.DistributedDataParallel
    device = next(model.parameters()).device
    no_sync = ("forward_sync_buffers"
               if "forward_sync_buffers" in inspect.signature(ddp).parameters
               else "broadcast_buffers")
    return ddp(model,
               device_ids=[device.index] if device.type == "cuda" else None,
               **{no_sync: False})


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
