"""A classification config's train step alone on the card, and where its
device time goes: the shared body of `<Family>/torch/profile_step.py`.

`main(model)` builds the port's classification Trainer for the config
`model` at full width and its own resolution on `cuda` (the config's
optimizer, schedule, label smoothing and aux weight; bf16 convs with f32
BatchNorm and heads), stages one synthetic f32 batch on the card, and
prints:
- the step alone (`Trainer.run_step`: forward, backward, optimizer) on
  that batch without the profiler: CUDA events over `--steps` steps after
  the warm-up, images/s and the peak memory allocated;
- the least time the card could take for the step: 3x the forward's
  operations (2 per multiply-add, counted from the shapes of every conv
  and dense layer in a train-mode forward, aux heads included) at the
  bf16 peak of 989 TFLOP/s, or, if larger, the bytes every step must move
  (the batch read once; the f32 weights read, their gradients written
  and the optimizer's f32 state read and written) at 3.35 TB/s;
- per step under `torch.profiler` (tools/step_profile.py): the device
  time of each kernel family, the device's busy and idle share, and the
  top kernels.
It exits non-zero without a card, and when the trace holds no device time
or no convolution.
"""

from __future__ import annotations

import argparse
import copy
import shutil
import sys
import tempfile
from typing import Optional, Sequence

import torch
from torch import nn

from ..configs import get_config
from ..core.trainer import Trainer
from ..data.synthetic import SyntheticClassification
from ..utils.timing import loop_ms
from .step_profile import print_report, profile_steps

# published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def forward_flops(model: nn.Module, images: torch.Tensor) -> float:
    """Operations (2 per multiply-add) of one train-mode forward of a copy
    of `model` on `images`, from the shapes of the convs and dense layers
    it calls as modules (the zoo's every one; not a weight that a forward
    passes to `F.linear` itself, as LeNet-5's and ResNet's heads): each
    output element of a conv costs in/groups * kh * kw multiply-adds, of a
    dense layer in_features."""
    m = copy.deepcopy(model).train()
    total = [0]

    def hook(mod, _inputs, out):
        per_out = (mod.weight[0].numel() if isinstance(mod, nn.Conv2d)
                   else mod.in_features)
        total[0] += 2 * out.numel() * per_out

    for mod in m.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            mod.register_forward_hook(hook)
    gen = torch.Generator(device=images.device).manual_seed(0)
    with torch.no_grad():
        m(images, generator=gen)
    return float(total[0])


def step_bound_ms(flops: float, batch_bytes: int, params: int
                  ) -> tuple:
    """(ms, "operations" or "bytes"): 3 forwards' operations at the bf16
    peak against the batch read once and 4 f32 passes over the weights
    (read, gradient written, optimizer state read and written)."""
    t_ops = 3 * flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (batch_bytes + 4 * 4 * params) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main(model: str, argv: Optional[Sequence[str]] = None) -> int:
    cfg = get_config(model)
    p = argparse.ArgumentParser(
        description=f"{model}'s train step alone on the card, split by "
                    f"kernel family")
    p.add_argument("--batch-size", type=int, default=cfg.batch_size)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 1
    cfg = cfg.replace(batch_size=args.batch_size)
    workdir = tempfile.mkdtemp(prefix="profile_step_")
    try:
        return _profile(cfg, args, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _profile(cfg, args, workdir: str) -> int:
    name, batch, size = cfg.name, args.batch_size, cfg.data.image_size
    card = torch.cuda.get_device_name(0)
    trainer = Trainer(cfg, device="cuda", workdir=workdir)
    trainer.init_state()
    staged = trainer._to_device(next(iter(SyntheticClassification(
        batch, size, cfg.data.channels, cfg.data.num_classes, 1, seed=0))))
    model = trainer.state.model
    flops = forward_flops(model, staged[0][:2]) * (
        batch / 2)
    params = sum(p.numel() for p in model.parameters())
    bound, bound_by = step_bound_ms(flops, staged[0].numel() * 4, params)
    torch.cuda.reset_peak_memory_stats()
    step_ms = loop_ms(lambda: trainer.run_step(staged), args.steps,
                      warmup=args.warmup)
    peak = torch.cuda.max_memory_allocated()
    print(f"{name} train step, batch {batch}, {size} px, {card}: step_ms "
          f"{step_ms:.3f} (CUDA events, {args.steps} steps after "
          f"{args.warmup} warm-up), images/s {batch / step_ms * 1e3:.1f}, "
          f"peak memory allocated {peak / 2**30:.3f} GiB", flush=True)
    print(f"{name} bound: forward {flops / batch / 1e9:.3f} GFLOP/image "
          f"(convs and dense layers, 2 per multiply-add), step "
          f"{3 * flops / 1e12:.3f} TFLOP; {params:,} parameters; "
          f"bound_ms {bound:.3f} ({bound_by}); step_ms/bound "
          f"{step_ms / bound:.1f}; achieved "
          f"{3 * flops / step_ms / 1e9:.1f} TFLOP/s", flush=True)
    stats = profile_steps(lambda i: trainer.run_step(staged), args.warmup,
                          args.steps)
    trainer.close()
    if stats["busy_ms"] <= 0 or stats["family_ms"].get("conv_gemm", 0) <= 0:
        print(f"profile_step: the trace holds no device time or no "
              f"convolution: {stats['family_ms']}", file=sys.stderr)
        return 1
    print_report(f"{name} train step, batch {batch}, {card}", stats)
    return 0
