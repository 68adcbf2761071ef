"""Driver entry points of the port (counterpart of __graft_entry__.py).

- `entry(device=None)`: `(fn, args)`, the port's ResNet-50 eval forward
  at batch 8, 224 px, 1000 classes, on the card unless `device="cpu"`.
- `dryrun_multichip(n, device="cpu")`: n ranks, one process each, over
  gloo on the CPU or over NCCL on n cards with `device="cuda"`; every
  rank runs the data-parallel parts of the JAX dryrun on its rows of the
  global batch (2 rows a rank, 32 px): one full ResNet-50 train step
  (momentum SGD at LR 0.1, weight decay 1e-4, cosine schedule, label
  smoothing 0.1, f32 compute), the `resnet50_lean` bf16 step with f32
  master weights, and `accum_steps=2` (no update after the first
  micro-step, one after the second). Rank 0 prints one
  `dryrun_multichip: ...` line for each.

`python -m deepvision_tpu_torch.graft_entry [--device cpu] [-n N]` runs
both (N defaults to the card count, or 2 on the CPU). The JAX dryrun's
spatial, spatial x model, shard_map and steps_per_dispatch parts need the
model and spatial axes of the mesh, which are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import models  # noqa: F401  (registers the zoo)
from .core.config import OptimizerConfig, ScheduleConfig
from .core.optim import build_optimizer
from .core.steps import make_classification_train_step
from .core.train_state import TrainState
from .core.trainer import say
from .parallel import mesh
from .utils.device import resolve_device
from .utils.registry import MODELS

# The port's steps update their state in place and donate nothing; jaxlint's
# project-wide reach resolves `make_classification_train_step` by name to
# the JAX package's donating one.
# jaxlint: disable-file=DON001

DRYRUN_CLASSES = 100
DRYRUN_SIZE = 32
ROWS_PER_RANK = 2


def entry(device=None) -> Tuple[Callable, tuple]:
    """(fn, example_args): the ResNet-50 eval forward (random weights from
    seed 0) on ones of shape (8, 224, 224, 3); `fn(*args)` gives the
    (8, 1000) f32 logits."""
    dev = resolve_device(device)
    model = MODELS.get("resnet50")(
        num_classes=1000, generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    images = torch.ones((8, 224, 224, 3), device=dev)

    @torch.inference_mode()
    def forward(x: torch.Tensor) -> torch.Tensor:
        return model(x)

    return forward, (images,)


def _state(name: str, opt: OptimizerConfig, device) -> TrainState:
    model = MODELS.get(name)(num_classes=DRYRUN_CLASSES,
                             generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    return TrainState(model, build_optimizer(
        model.parameters(), opt, ScheduleConfig(name="cosine"),
        steps_per_epoch=10, total_epochs=10))


def _dryrun_rank(device: str) -> None:
    """The dryrun's three steps on this rank (under a process group)."""
    device = resolve_device(device)
    world, rank = mesh.world_size(), mesh.rank()
    where = (f"n={world} backend={torch.distributed.get_backend()} "
             f"device={device}")
    batch = ROWS_PER_RANK * world

    def rows(images, labels):
        return tuple(torch.from_numpy(np.ascontiguousarray(
            mesh.shard_rows(a, rank, world))).to(device)
            for a in (images, labels))

    images = np.random.RandomState(0).randn(
        batch, DRYRUN_SIZE, DRYRUN_SIZE, 3).astype(np.float32)
    labels = np.arange(batch, dtype=np.int32) % DRYRUN_CLASSES
    images2 = np.random.RandomState(1).randn(
        batch, DRYRUN_SIZE, DRYRUN_SIZE, 3).astype(np.float32)
    labels2 = (np.arange(batch, dtype=np.int32) + 7) % DRYRUN_CLASSES
    opt = OptimizerConfig(name="momentum", learning_rate=0.1,
                          weight_decay=1e-4)
    f32_step = make_classification_train_step(label_smoothing=0.1,
                                              compute_dtype=torch.float32)

    state = _state("resnet50", opt, device)
    loss = float(f32_step(state, *rows(images, labels))["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    say(f"dryrun_multichip: {where} global_batch={batch} step={state.step} "
        f"loss={loss:.4f}")

    state = _state("resnet50_lean", opt, device)
    lean_step = make_classification_train_step(label_smoothing=0.1,
                                               compute_dtype=torch.bfloat16)
    loss = float(lean_step(state, *rows(images, labels))["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite resnet50_lean loss {loss}")
    if not all(p.dtype == torch.float32 for p in state.model.parameters()):
        raise AssertionError("resnet50_lean master weights left f32")
    say(f"dryrun_multichip: resnet50_lean (bf16 lowp) {where} "
        f"loss={loss:.4f}")

    state = _state("resnet50", dataclasses.replace(opt, accum_steps=2),
                   device)
    before = [p.detach().clone() for p in state.model.parameters()]
    f32_step(state, *rows(images, labels))
    if not all(torch.equal(a, p) for a, p in zip(
            before, state.model.parameters())):
        raise AssertionError("accum_steps=2: params changed after the "
                             "FIRST micro-batch")
    loss = float(f32_step(state, *rows(images2, labels2))["loss"])
    if all(torch.equal(a, p) for a, p in zip(before,
                                             state.model.parameters())):
        raise AssertionError("accum_steps=2: no update applied after the "
                             "second micro-batch")
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite accum_steps=2 loss {loss}")
    say(f"dryrun_multichip: accum_steps=2 {where} update applied on "
        f"micro-step 2")


def dryrun_multichip(n: int, device: str = "cpu",
                     threads: Optional[int] = None) -> None:
    """Spawn n ranks and run the dryrun's steps on each (see the module);
    raises if any rank fails. `threads` is each CPU rank's intra-op thread
    count (default: the host's cores shared out)."""
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}, 'cuda') needs {n} cards; "
                           f"this host has {torch.cuda.device_count()}")
    mesh.spawn_ranks(_dryrun_rank, (device,), world=n,
                     backend="gloo" if device == "cpu" else "nccl",
                     threads=threads or max(1, (os.cpu_count() or 1) // n))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default: NCCL over the cards) or cpu (gloo)")
    p.add_argument("-n", type=int, default=None,
                   help="ranks (default: the card count, 2 on the CPU)")
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print(f"entry: out {tuple(out.shape)} {out.dtype} on {out.device}",
          flush=True)
    n = args.n or (torch.cuda.device_count() if args.device == "cuda"
                   else 2)
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
