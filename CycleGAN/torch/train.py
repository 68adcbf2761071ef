#!/usr/bin/env python
"""Train CycleGAN with the PyTorch port on an NVIDIA GPU — `python train.py
--dataset <name> | --synthetic`.

The flags are the JAX entry point's (`CycleGAN/jax/train.py`): `--dataset`
(`tfrecords/<dataset>/{trainA,trainB}.tfrecord`), `--batch-size`,
`--epochs`, `--image-size`, `--workdir`, `--resume`, `--synthetic` and
`--steps-per-epoch` and `--recover-on-divergence`, plus `--device` (cuda
by default; a host with no card raises) and `--tfrecords-dir` (the root
that holds `<dataset>/`, `tfrecords` by default). The two-domain records
decode on the card (data/gan.py); an epoch is every zipped batch (the
records counted up front, as the JAX entry point counts its batches).
`--synthetic` trains on a 64 px canvas unless `--image-size` is given. SIGTERM commits a checkpoint
and exits 0; `--resume` continues. `--profile-dir` and
`--compilation-cache` are XLA's. For example,
two steps at the full 256 px and the config's batch of 8:

    python CycleGAN/torch/train.py --synthetic --image-size 256 \
        --steps-per-epoch 2 --epochs 1
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train CycleGAN (PyTorch port).")
    p.add_argument("--dataset", help="dataset name under tfrecords/")
    p.add_argument("--tfrecords-dir", default="tfrecords",
                   help="the directory of <dataset>/{trainA,trainB}"
                        ".tfrecord")
    p.add_argument("--batch_size", "--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--image-size", type=int, default=None,
                   help="default 256, or 64 with --synthetic")
    p.add_argument("--workdir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="random two-domain data smoke run")
    p.add_argument("--steps-per-epoch", type=int, default=2)
    p.add_argument("--recover-on-divergence", type=int, default=None,
                   metavar="N",
                   help="roll both networks back to the last committed "
                        "checkpoint and retry (LR scaled down) up to N "
                        "times when an epoch's metrics go non-finite "
                        "(default 0: halt)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.recover_on_divergence is not None \
            and args.recover_on_divergence < 0:
        p.error(f"--recover-on-divergence must be >= 0, got "
                f"{args.recover_on_divergence}")
    if not args.synthetic and not args.dataset:
        p.error("--dataset is required without --synthetic")

    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.gan import CycleGANTrainer
    from deepvision_tpu_torch.core.trainer import fit_and_close
    from deepvision_tpu_torch.data import gan as gan_data

    cfg = get_config("cyclegan")
    if args.epochs:
        cfg = cfg.replace(total_epochs=args.epochs)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    if args.recover_on_divergence is not None:
        cfg = cfg.replace(recover_on_divergence=args.recover_on_divergence)
    image_size = args.image_size or (64 if args.synthetic else 256)
    workdir = args.workdir or (
        f"runs/cyclegan-{args.dataset}" if args.dataset else "runs/cyclegan")

    if args.synthetic:
        steps_per_epoch = args.steps_per_epoch

        def train_fn(epoch):
            return gan_data.synthetic_two_domain_batches(
                cfg.batch_size, image_size=image_size,
                steps=steps_per_epoch, seed=epoch)
    else:
        from deepvision_tpu_torch.utils.device import resolve_device
        root = os.path.join(args.tfrecords_dir, args.dataset)
        ds = gan_data.build_two_domain_dataset(
            os.path.join(root, "trainA.tfrecord"),
            os.path.join(root, "trainB.tfrecord"),
            batch_size=cfg.batch_size, image_size=image_size, seed=cfg.seed,
            device=resolve_device(args.device))
        # the epoch's length anchors LinearDecay (the reference counts
        # its batches too, train.py:108-120)
        steps_per_epoch = ds.num_batches()
        print(f"Batch size: {cfg.batch_size}, "
              f"Total batches per epoch: {steps_per_epoch}")

        def train_fn(epoch, _ds=ds):
            return iter(_ds)

    trainer = CycleGANTrainer(cfg, workdir=workdir, device=args.device,
                              steps_per_epoch=steps_per_epoch)
    if args.resume:
        got = trainer.resume()
        print(f"resumed from epoch {got}" if got else "no checkpoint found")
    metrics = fit_and_close(trainer, train_fn)
    print(f"done: {metrics}")
    return trainer, metrics


if __name__ == "__main__":
    main()
