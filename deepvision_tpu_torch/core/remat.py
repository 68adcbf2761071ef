"""Recompute of the train forward in the backward: the port's counterpart
of the JAX steps' `jax.checkpoint(forward,
policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)`
(`TrainConfig.remat`).

`Remat(model)` runs `model`'s forward under the non-reentrant
`torch.utils.checkpoint` with a selective policy
(`create_selective_checkpoint_contexts`): the outputs of `mm` and `addmm`,
the dense layers' matmuls, which have no batch dimension, are saved; every
other op (convolutions, batched matmuls, normalizations, activations, and
the attention kernel K1, which is not a dot) is recomputed when the
backward needs it, as under JAX's policy. On the card K1 thus launches
again in the recompute.

Two things the recompute must not change, each of which would give a
silently wrong step:
- **Dropout.** The port draws its masks from an explicit generator passed
  to the forward (`generator=`); `preserve_rng_state` restores only the
  global generators. The wrapper saves that generator's state before the
  forward and sets it back before the recompute: the same masks.
- **BatchNorm's running statistics.** A train-mode forward updates them,
  and the recompute would update them a second time. The wrapper runs the
  recompute under `models/common.py::recomputing`, where the port's
  `BatchNorm` normalizes as in the forward and leaves its statistics
  alone: they are those of the one forward, as the JAX step's
  `batch_stats` are. (The selective checkpoint refuses ops in the
  recompute that the forward did not run, so the statistics cannot be
  saved and put back around it.)

`Remat` is a module so that under a process group DDP wraps it
(`TrainState.train_model`): the checkpoint runs inside DDP's forward and
the recompute inside its backward, and the reducer sees each parameter's
gradient once.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.common import recomputing

# the ops whose outputs the policy keeps: the matmuls without a batch
# dimension
SAVED_OPS = frozenset({torch.ops.aten.mm.default,
                       torch.ops.aten.addmm.default})


def _policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _contexts():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_policy)


class Remat(nn.Module):
    """`inner`'s forward, its activations recomputed in the backward
    (module docstring). Holds no state of its own: `inner` keeps the
    parameters and buffers."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, *args, **kwargs):
        from torch.utils.checkpoint import checkpoint
        generator = kwargs.get("generator")
        rng = generator.get_state() if generator is not None else None
        calls = []

        def run(*a):
            if not calls:
                calls.append(1)
                return self.inner(*a, **kwargs)
            # the recompute: the forward's dropout draws, and the running
            # statistics as the forward left them
            if generator is not None:
                generator.set_state(rng)
            with recomputing():
                return self.inner(*a, **kwargs)

        return checkpoint(run, *args, use_reentrant=False,
                          context_fn=_contexts)
