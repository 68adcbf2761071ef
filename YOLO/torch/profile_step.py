#!/usr/bin/env python
"""Where a yolov3 train step's time goes on the card, by kernel family.

    python YOLO/torch/profile_step.py [--batch-size 16] [--image-size 416]

Builds the port's DetectionTrainer for `yolov3` at full width on `cuda`,
runs warm-up steps on synthetic batches, then traces `--steps` steps with
`torch.profiler` and prints, per step, the device time of each kernel
family (convolution and GEMM, BatchNorm, elementwise, reductions, the Adam
update, best_iou, copies, other), the device's busy and idle share of the
wall time, and the 15 kernels with the most device time. Exits non-zero
without a card or when the trace holds no device time.
"""
import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch  # noqa: E402

from deepvision_tpu_torch.configs import get_config  # noqa: E402
from deepvision_tpu_torch.core.detection import DetectionTrainer  # noqa: E402
from deepvision_tpu_torch.data.detection import synthetic_batches  # noqa: E402

# kernel-name fragments, checked in order; the first match names the family
FAMILIES = (
    ("best_iou", ("best_iou",)),
    ("adam", ("adam", "multi_tensor_apply")),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("conv_gemm", ("conv", "cudnn", "gemm", "xmma", "sm90", "implicit",
                   "wgrad", "dgrad", "cutlass", "nchwtonhwc", "nhwctonchw")),
    ("reduce", ("reduce",)),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index",
                     "scatter", "gather", "cat", "upsample", "pad")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--image-size", type=int, default=416)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 1
    cfg = get_config("yolov3")
    cfg = cfg.replace(batch_size=args.batch_size, data=dataclasses.replace(
        cfg.data, image_size=args.image_size, dataset="synthetic"))
    workdir = tempfile.mkdtemp(prefix="profile_step_")
    try:
        return profile(cfg, args, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def profile(cfg, args, workdir: str) -> int:
    trainer = DetectionTrainer(cfg, device="cuda", workdir=workdir)
    state = trainer.init_state()
    batches = [trainer._to_device(b) for b in synthetic_batches(
        batch_size=args.batch_size, image_size=args.image_size,
        num_classes=cfg.data.num_classes, steps=args.warmup + args.steps)]
    for b in batches[:args.warmup]:
        trainer.train_step(state, *b)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches[args.warmup:]:
            trainer.train_step(state, *b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    trainer.close()

    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    totals, by_name = {}, {}
    for e in events:
        us = e.time_range.elapsed_us()      # the kernel's own duration
        totals[family(e.name)] = totals.get(family(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_ms = sum(totals.values()) / 1e3 / args.steps
    if busy_ms <= 0:
        print("profile_step: the trace holds no device time", file=sys.stderr)
        return 1
    print(f"yolov3 train step, batch {args.batch_size}, {args.image_size} px, "
          f"{torch.cuda.get_device_name(0)}: wall {wall_ms:.3f} ms/step "
          f"(profiled), device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%; "
          f"{len(events) / args.steps:.0f} kernels/step")
    for fam, us in sorted(totals.items(), key=lambda kv: -kv[1]):
        ms = us / 1e3 / args.steps
        print(f"  {fam:12s} {ms:9.3f} ms/step  {100 * ms / busy_ms:5.1f}% "
              f"of device time")
    print("top kernels (ms/step):")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3 / args.steps:9.3f}  [{family(name)}] {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
