#!/usr/bin/env python
"""Where a resnet50_tpu train step's time goes on the card, by kernel family.

    python ResNet/torch/profile_step.py [--batch-size 256] [--steps 5]

Builds the port's classification Trainer for `resnet50_tpu` at full width
(Bottleneck ResNet-50, 224 px, 1000 classes, bf16 convs with f32
BatchNorm and head, momentum 0.9, weight decay 1e-4 without decay on 1-D
tensors, label smoothing 0.1, EMA 0.9999) with the device augmentation, on
`cuda` and synthetic uint8 batches at the decode size (256 px) already on
the card. Prints:
- what one batch's input costs before a step: its synthetic uint8
  generation on the host (numpy, host clock) and its H2D copy from pinned
  and from pageable memory (CUDA events);
- the step alone (`Trainer.run_step`: augment, forward, backward, SGD,
  EMA) without the profiler: CUDA events over `--steps` steps after the
  warm-up, images/s and the peak memory allocated;
- per step under `torch.profiler` (deepvision_tpu_torch/tools/
  step_profile.py): the device time of each kernel family — convolutions,
  BatchNorm with its `var_mean` pass apart, casts, elementwise, the
  optimizer, the EMA, the augment — the device's busy and idle share, and
  the top kernels.
Exits non-zero without a card or when the trace holds no device time or no
convolution. Under `torchrun --standalone --nproc_per_node=1` it profiles
the step under DDP at world 1 (the global-batch BatchNorm's all-reduces
and DDP's, the `nccl` family).
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
from deepvision_tpu_torch.core.config import decode_image_size  # noqa: E402
from deepvision_tpu_torch.core.trainer import Trainer  # noqa: E402
from deepvision_tpu_torch.data.synthetic import \
    SyntheticClassification  # noqa: E402
from deepvision_tpu_torch.parallel import mesh  # noqa: E402
from deepvision_tpu_torch.tools.step_profile import (  # noqa: E402
    print_report, profile_steps, run_tag)
from deepvision_tpu_torch.utils.timing import loop_ms  # noqa: E402

MODEL = "resnet50_tpu"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 1
    cfg = get_config(MODEL).replace(batch_size=args.batch_size,
                                    device_augment=True)
    workdir = tempfile.mkdtemp(prefix="profile_step_")
    mesh.maybe_init_distributed()      # under torchrun: one rank's step
    try:
        return profile(cfg, args, workdir)
    finally:
        mesh.destroy()
        shutil.rmtree(workdir, ignore_errors=True)


def batches(cfg, batch: int, n: int, seed: int):
    """`n` synthetic uint8 batches at the decode size, as the CLI makes
    them under `--device-augment`."""
    return SyntheticClassification(
        batch, decode_image_size(cfg.data.image_size), cfg.data.channels,
        cfg.data.num_classes, n, seed=seed, emit_uint8=True)


def input_ms(cfg, batch: int) -> tuple:
    """(host ms to generate one uint8 batch, ms of its H2D copy from pinned
    memory, from pageable memory, its bytes)."""
    t0 = time.perf_counter()
    images, _ = next(iter(batches(cfg, batch, 1, seed=1)))
    gen_ms = (time.perf_counter() - t0) * 1e3
    pageable = torch.from_numpy(images)
    pinned = pageable.pin_memory()
    pinned_ms = loop_ms(lambda: pinned.to("cuda", non_blocking=True), 3,
                        warmup=1)
    pageable_ms = loop_ms(lambda: pageable.to("cuda"), 3, warmup=1)
    return gen_ms, pinned_ms, pageable_ms, images.nbytes


def profile(cfg, args, workdir: str) -> int:
    gen_ms, pinned_ms, pageable_ms, nbytes = input_ms(cfg, args.batch_size)
    print(f"input per batch of {args.batch_size}: synthetic uint8 "
          f"generation at {decode_image_size(cfg.data.image_size)} px on the "
          f"host {gen_ms:.1f} ms (numpy, host clock); H2D copy of "
          f"{nbytes / 1e6:.1f} MB: pinned {pinned_ms:.3f} ms, pageable "
          f"{pageable_ms:.3f} ms (CUDA events)", flush=True)
    trainer = Trainer(cfg, device="cuda", workdir=workdir)
    trainer.init_state()
    n = args.warmup + args.steps
    staged = [trainer._to_device(b)
              for b in batches(cfg, args.batch_size, n, seed=0)]
    torch.cuda.reset_peak_memory_stats()
    stream = iter(staged)
    step_ms = loop_ms(lambda: trainer.run_step(next(stream)), args.steps,
                      warmup=args.warmup)
    peak = torch.cuda.max_memory_allocated()
    print(f"{MODEL} train step, batch {args.batch_size}, "
          f"{torch.cuda.get_device_name(0)}{run_tag()}: step_ms "
          f"{step_ms:.3f} "
          f"(CUDA events, {args.steps} steps after {args.warmup} warm-up), "
          f"images/s {args.batch_size / step_ms * 1e3:.1f}, peak memory "
          f"allocated {peak / 2**30:.3f} GiB", flush=True)
    stats = profile_steps(lambda i: trainer.run_step(staged[i]),
                          args.warmup, args.steps)
    trainer.close()
    if stats["busy_ms"] <= 0 or stats["family_ms"].get("conv_gemm", 0) <= 0:
        print(f"profile_step: the trace holds no device time or no "
              f"convolution: {stats['family_ms']}", file=sys.stderr)
        return 1
    print_report(f"{MODEL} train step, batch {args.batch_size}, "
                 f"{torch.cuda.get_device_name(0)}{run_tag()}", stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
