#!/usr/bin/env python
"""Train DCGAN on MNIST with the PyTorch port on an NVIDIA GPU — `python
main.py [--synthetic] [--resume]`.

The flags are the JAX entry point's (`DCGAN/jax/main.py`): `--data-dir`
(MNIST idx files), `--epochs`, `--batch-size`, `--workdir`, `--resume`,
`--synthetic` and `--steps-per-epoch`, plus `--device` (cuda by default;
a host with no card raises) and `--recover-on-divergence N` (roll back
and retry a non-finite epoch up to N times). SIGTERM commits a checkpoint
and exits 0; `--resume` continues. `--profile-dir` and
`--compilation-cache` are XLA's and have no counterpart here. For
example, three synthetic steps at the config's batch of 256:

    python DCGAN/torch/main.py --synthetic --steps-per-epoch 3 --epochs 1
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train DCGAN (PyTorch port).")
    p.add_argument("--data-dir", default="dataset/mnist")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--workdir", default="runs/dcgan")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="random data smoke run, no dataset needed")
    p.add_argument("--steps-per-epoch", type=int, default=4,
                   help="steps per epoch in --synthetic mode")
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

    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.gan import DCGANTrainer
    from deepvision_tpu_torch.core.trainer import fit_and_close
    from deepvision_tpu_torch.data import gan as gan_data

    cfg = get_config("dcgan")
    if args.epochs:
        cfg = cfg.replace(total_epochs=args.epochs)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    if args.recover_on_divergence is not None:
        cfg = cfg.replace(recover_on_divergence=args.recover_on_divergence)

    trainer = DCGANTrainer(cfg, workdir=args.workdir, device=args.device)
    if args.resume:
        got = trainer.resume()
        print(f"resumed from epoch {got}" if got else "no checkpoint found")

    if args.synthetic:
        def train_fn(epoch):
            return gan_data.synthetic_mnist_batches(
                cfg.batch_size, steps=args.steps_per_epoch, seed=epoch)
    else:
        def train_fn(epoch):
            return gan_data.mnist_gan_batches(args.data_dir, cfg.batch_size,
                                              seed=epoch)

    metrics = fit_and_close(trainer, train_fn)
    print(f"done: {metrics}")
    return trainer, metrics


if __name__ == "__main__":
    main()
