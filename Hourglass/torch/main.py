#!/usr/bin/env python
"""Train the Stacked Hourglass with the PyTorch port, then export the best
checkpoint (`Hourglass/jax/main.py`'s flags, plus `--device`).

The role of the reference's click CLI (`Hourglass/tensorflow/main.py:
21-66`): train through `cli.run_pose`, then copy the best epoch's
checkpoint directory (else the latest's) to
`<export-dir>/hourglass-v<version>-epoch-<n>` and write that path to
`output.txt` in the temporary directory (`/tmp/output.txt` unless TMPDIR
says otherwise). A `gs://`, `s3://`, `memory://`... destination is
written through fsspec (deepvision_tpu_torch/data/fs.py); a protocol
whose package is absent is refused by name.

    python Hourglass/torch/main.py --synthetic --epochs 2 \
        --workdir runs/hourglass104 --export-dir exported --version 0.0.2
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_heatmap", type=int, default=16)
    p.add_argument("--checkpoint", default=None,
                   help="'latest' or epoch number")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--workdir", default="runs/hourglass104")
    p.add_argument("--export-dir", default=None,
                   help="copy the best checkpoint here after training "
                        "(a URL goes through fsspec)")
    p.add_argument("--version", default="0.0.1")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None):
    """Returns the export's destination, or None when nothing was
    exported."""
    args = build_parser().parse_args(argv)

    from deepvision_tpu_torch.cli import run_pose
    from deepvision_tpu_torch.core.checkpoint import CheckpointManager
    from deepvision_tpu_torch.data import fs

    if args.export_dir and fs.is_remote(args.export_dir):
        fs.filesystem(args.export_dir)   # refuse before training
    run_argv = ["-m", "hourglass104", "--epochs", str(args.epochs),
                "--learning-rate", str(args.learning_rate),
                "--num-classes", str(args.num_heatmap),
                "--workdir", args.workdir, "--device", args.device]
    if args.batch_size:
        run_argv += ["--batch-size", str(args.batch_size)]
    if args.checkpoint:
        run_argv += ["-c", args.checkpoint]
    if args.data_dir:
        run_argv += ["--data-dir", args.data_dir]
    if args.synthetic:
        run_argv += ["--synthetic"]
    run_pose("Hourglass", ["hourglass104"], run_argv)

    if not args.export_dir:
        return None
    # export the best epoch's checkpoint tree (`main.py:53-66` GCS role)
    ckpt = CheckpointManager(os.path.join(args.workdir, "ckpt"))
    try:
        best = ckpt.best_epoch() or ckpt.latest_epoch()
    finally:
        ckpt.close()
    if best is None:
        print("no checkpoint to export")
        return None
    src = os.path.join(args.workdir, "ckpt", str(best))
    name = f"hourglass-v{args.version}-epoch-{best}"
    dst = fs.copytree(src, fs.join(args.export_dir, name))
    print(f"Exported best model (epoch {best}) to {dst}")
    with open(os.path.join(tempfile.gettempdir(), "output.txt"), "w") as fp:
        fp.write(dst + "\n")           # `main.py:64-66` parity
    return dst


if __name__ == "__main__":
    main()
