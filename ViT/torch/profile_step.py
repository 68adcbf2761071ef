#!/usr/bin/env python
"""Where a vit_small train step's time goes on the card, by kernel family.

    python ViT/torch/profile_step.py [--batch-size 256] [--steps 5]

Builds the port's classification Trainer for `vit_small` at full width
(224 px, depth 8, bf16 compute, adam with clip and warmup, label smoothing
0.1, dropout 0.1) on `cuda` and synthetic batches already on the card.
Prints:
- what one batch's input costs before a step: its synthetic generation on
  the host (numpy, host clock) and its pageable H2D copy (CUDA events),
  both paid inside the trainer's loop;
- the step time without the profiler (CUDA events over `--steps` steps
  after the warm-up), images/s and the peak memory allocated;
- per step under `torch.profiler` (deepvision_tpu_torch/tools/
  step_profile.py): the device time of each kernel family — the
  flash-attention forward (K1), the attention backward (the naive VJP's
  matmuls and softmax, counted from the autograd node's range), the other
  GEMMs, LayerNorm, elementwise, the optimizer, copies — the device's busy
  and idle share, and the top kernels;
- the attention backward alone: `depth` naive VJPs at the step's
  (B, 6, 197, 64) bf16 in the model's strided layout, between CUDA events.
Exits non-zero without a card or when the trace holds no device time or
no attention.
"""
import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch  # noqa: E402

from deepvision_tpu_torch.configs import get_config  # noqa: E402
from deepvision_tpu_torch.core.trainer import Trainer  # noqa: E402
from deepvision_tpu_torch.data.synthetic import \
    SyntheticClassification  # noqa: E402
from deepvision_tpu_torch.ops.attention import flash_attention  # noqa: E402
from deepvision_tpu_torch.tools.step_profile import (  # noqa: E402
    print_report, profile_steps)
from deepvision_tpu_torch.utils.timing import loop_ms  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 1
    cfg = get_config("vit_small").replace(batch_size=args.batch_size)
    workdir = tempfile.mkdtemp(prefix="profile_step_")
    try:
        return profile(cfg, args, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def attention_backward_ms(cfg, batch: int, iters: int = 5) -> float:
    """`depth` naive VJPs of the flash-attention Function at the step's
    shape in the model's strided head-split layout, bf16."""
    kw = cfg.model_kwargs
    h, c = kw["num_heads"], kw["embed_dim"]
    n = (cfg.data.image_size // kw["patch_size"]) ** 2 + 1
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = [torch.randn((batch, n, c), generator=g, device="cuda")
           .bfloat16().view(batch, n, h, c // h).permute(0, 2, 1, 3)
           .requires_grad_(True) for _ in range(3)]
    out = flash_attention(*qkv)
    grad = torch.randn(out.shape, generator=g, device="cuda").bfloat16()

    def backward():
        for _ in range(kw["depth"]):
            torch.autograd.grad(out, qkv, grad, retain_graph=True)

    return loop_ms(backward, iters, warmup=1)


def input_ms(cfg, batch: int) -> tuple:
    """(host ms to generate one synthetic batch, ms of its pageable H2D
    copy, its bytes)."""
    t0 = time.perf_counter()
    images, _ = next(iter(SyntheticClassification(
        batch, cfg.data.image_size, cfg.data.channels, cfg.data.num_classes,
        1, seed=1)))
    gen_ms = (time.perf_counter() - t0) * 1e3
    pixels = torch.from_numpy(images)
    copy_ms = loop_ms(lambda: pixels.to("cuda"), 3, warmup=1)
    return gen_ms, copy_ms, images.nbytes


def profile(cfg, args, workdir: str) -> int:
    gen_ms, copy_ms, nbytes = input_ms(cfg, args.batch_size)
    print(f"input per batch of {args.batch_size}: synthetic generation on "
          f"the host {gen_ms:.1f} ms (numpy, host clock); pageable H2D copy "
          f"of {nbytes / 1e6:.1f} MB of f32 pixels {copy_ms:.3f} ms (CUDA "
          f"events)", flush=True)
    trainer = Trainer(cfg, device="cuda", workdir=workdir)
    state = trainer.init_state()
    n = args.warmup + args.steps
    batches = [trainer._to_device(b) for b in SyntheticClassification(
        args.batch_size, cfg.data.image_size, cfg.data.channels,
        cfg.data.num_classes, n, seed=0)]
    torch.cuda.reset_peak_memory_stats()
    stream = iter(batches)
    step_ms = loop_ms(lambda: trainer.train_step(state, *next(stream)),
                      args.steps, warmup=args.warmup)
    peak = torch.cuda.max_memory_allocated()
    print(f"vit_small train step, batch {args.batch_size}, "
          f"{torch.cuda.get_device_name(0)}: step_ms {step_ms:.3f} "
          f"(CUDA events, {args.steps} steps after {args.warmup} warm-up), "
          f"images/s {args.batch_size / step_ms * 1e3:.1f}, peak memory "
          f"allocated {peak / 2**30:.3f} GiB", flush=True)
    stats = profile_steps(lambda i: trainer.train_step(state, *batches[i]),
                          args.warmup, args.steps)
    trainer.close()
    fam = stats["family_ms"]
    if stats["busy_ms"] <= 0 or fam.get("flash_attention", 0.0) <= 0:
        print(f"profile_step: the trace holds no device time or no "
              f"attention: {fam}", file=sys.stderr)
        return 1
    print_report(f"vit_small train step, batch {args.batch_size}, "
                 f"{torch.cuda.get_device_name(0)}", stats)
    bwd = sum(stats["ranges_ms"]["attention_backward"].values())
    print(f"attention backward (naive VJP) in the trace: {bwd:.3f} ms/step, "
          f"{100 * bwd / stats['busy_ms']:.1f}% of device time; K1 forward "
          f"{fam['flash_attention']:.3f} ms/step", flush=True)
    alone = attention_backward_ms(cfg, args.batch_size)
    print(f"attention backward alone: {cfg.model_kwargs['depth']} naive "
          f"VJPs at ({args.batch_size}, {cfg.model_kwargs['num_heads']}, "
          f"197, 64) bf16 strided: {alone:.3f} ms (CUDA events)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
