#!/usr/bin/env python
"""Stacked Hourglass PCKh with the PyTorch port. Usage:

    # the MPII val* TFRecords, the workdir's checkpoint
    python Hourglass/torch/evaluate.py --data-dir dataset/tfrecords_mpii
    # smoke: random weights on 2 synthetic batches of 4 at 64 px
    python Hourglass/torch/evaluate.py --synthetic

Prints `PCKh@<t>: …` for the mean and for each joint with data. The
weights are the workdir's checkpoint (`-c`, latest by default) on the
records; the records decode on the card (data/pose.py); `--image-size`
(not a JAX flag) evaluates at another size. `--device cpu` runs on the
CPU; without it a host with no card raises.
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
    p.add_argument("--image-size", type=int, default=None,
                   help="override the config's image size (records only)")
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
    if args.image_size:
        import dataclasses
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, image_size=args.image_size))
    if args.synthetic:
        from deepvision_tpu_torch.data.pose import synthetic_batches
        batches = synthetic_batches(batch_size=4, image_size=64, steps=2)
    else:
        from deepvision_tpu_torch.data.pose import build_dataset
        from deepvision_tpu_torch.utils.device import resolve_device
        data_dir = (args.data_dir or cfg.data.data_dir
                    or "dataset/tfrecords_mpii")
        batches = iter(build_dataset(
            os.path.join(data_dir, "val*"), batch_size=cfg.batch_size,
            image_size=cfg.data.image_size, training=False,
            device=resolve_device(args.device)))
    if args.max_batches:
        batches = itertools.islice(batches, args.max_batches)

    trainer = PoseTrainer(cfg, device=args.device, workdir=args.workdir)
    trainer.init_state()
    if not args.synthetic and trainer.resume(
            None if args.checkpoint == "latest"
            else int(args.checkpoint)) is None:
        print("WARNING: no checkpoint found — evaluating random weights")
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
