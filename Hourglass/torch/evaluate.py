#!/usr/bin/env python
"""Stacked Hourglass PCKh with the PyTorch port. Usage:

    # smoke: random weights on 2 synthetic batches of 4 at 64 px
    python Hourglass/torch/evaluate.py --synthetic

Prints `PCKh@<t>: …` for the mean and for each joint with data. A
workdir's `model_kwargs.json` pins the architecture it evaluates. The MPII
TFRecord validation split is not ported yet (it reads TFRecords through
TensorFlow, which the port does not depend on). `--device cpu` runs on
the CPU; without it a host with no card raises.
"""
import argparse
import itertools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--checkpoint", default="latest",
                   help="epoch number or 'latest'")
    p.add_argument("--workdir", default="runs/hourglass104")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--thresholds", default="0.5",
                   help="comma-separated PCKh thresholds")
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate random weights on synthetic batches "
                        "(smoke test)")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.eval_pose import evaluate_pckh
    from deepvision_tpu_torch.core.pose import PoseTrainer

    cfg = get_config("hourglass104")
    if not args.synthetic:
        raise NotImplementedError(
            "hourglass104 evaluates on the MPII TFRecord validation split, "
            "which is not ported yet: it reads TFRecords through "
            "TensorFlow, which the port does not depend on; use "
            "--synthetic")
    from deepvision_tpu_torch.data.pose import synthetic_batches
    batches = synthetic_batches(batch_size=4, image_size=64, steps=2)
    if args.max_batches:
        batches = itertools.islice(batches, args.max_batches)

    trainer = PoseTrainer(cfg, device=args.device, workdir=args.workdir)
    trainer.init_state()
    thresholds = tuple(float(t) for t in args.thresholds.split(","))
    metrics = evaluate_pckh(trainer.state, batches,
                            num_joints=cfg.data.num_classes,
                            thresholds=thresholds)
    trainer.close()
    for k in sorted(metrics):
        print(f"{k}: {metrics[k]:.4f}")
    return metrics


if __name__ == "__main__":
    main()
