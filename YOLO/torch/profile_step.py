#!/usr/bin/env python
"""Where a yolov3 train step's time goes on the card, by kernel family.

    python YOLO/torch/profile_step.py [--batch-size 16] [--image-size 416]

Builds the port's DetectionTrainer for `yolov3` at full width on `cuda`,
runs warm-up steps on synthetic batches, then traces `--steps` steps with
`torch.profiler` and prints, per step, the device time of each kernel
family (deepvision_tpu_torch/tools/step_profile.py: convolution and GEMM,
BatchNorm, elementwise, reductions, the optimizer, best_iou, copies,
other), the device's busy and idle share of the wall time, and the 15
kernels with the most device time. Exits non-zero without a card or when
the trace holds no device time. Under `torchrun --standalone
--nproc_per_node=1` it profiles the step under DDP at world 1 (the
global-batch BatchNorm's all-reduces and DDP's, the `nccl` family).
"""
import argparse
import dataclasses
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch  # noqa: E402

from deepvision_tpu_torch.configs import get_config  # noqa: E402
from deepvision_tpu_torch.core.detection import DetectionTrainer  # noqa: E402
from deepvision_tpu_torch.data.detection import synthetic_batches  # noqa: E402
from deepvision_tpu_torch.parallel import mesh  # noqa: E402
from deepvision_tpu_torch.tools.step_profile import (  # noqa: E402
    print_report, profile_steps, run_tag)


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
    mesh.maybe_init_distributed()      # under torchrun: one rank's step
    try:
        return profile(cfg, args, workdir)
    finally:
        mesh.destroy()
        shutil.rmtree(workdir, ignore_errors=True)


def profile(cfg, args, workdir: str) -> int:
    trainer = DetectionTrainer(cfg, device="cuda", workdir=workdir)
    state = trainer.init_state()
    batches = [trainer._to_device(b) for b in synthetic_batches(
        batch_size=args.batch_size, image_size=args.image_size,
        num_classes=cfg.data.num_classes, steps=args.warmup + args.steps)]
    stats = profile_steps(lambda i: trainer.train_step(state, *batches[i]),
                          args.warmup, args.steps)
    trainer.close()
    if stats["busy_ms"] <= 0:
        print("profile_step: the trace holds no device time", file=sys.stderr)
        return 1
    print_report(f"yolov3 train step, batch {args.batch_size}, "
                 f"{args.image_size} px, {torch.cuda.get_device_name(0)}"
                 f"{run_tag()}", stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
