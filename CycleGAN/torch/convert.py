#!/usr/bin/env python
"""Convert a trained CycleGAN generator into an AOTInductor package with
the PyTorch port: the serving path of a generator, as
`CycleGAN/jax/convert.py` (its flags, plus `--device`) converts one to
TFLite. The package takes (1, size, size, 3) f32 images in [-1, 1] named
`images`; every transposed convolution is rewritten into zero-stuffing
plus a plain convolution (deepvision_tpu_torch/core/export.py).

    python CycleGAN/torch/convert.py --workdir runs/cyclegan \
        --direction a2b --output photo2monet.pt2

`--saved-model-dir` also keeps the exported program; `--no-optimize` is
accepted and ignored (TFLite's weight quantization has no counterpart in
a float package).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="runs/cyclegan")
    p.add_argument("--direction", default="a2b", choices=["a2b", "b2a"])
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--output", default=None,
                   help="output package path (default <direction>.pt2)")
    p.add_argument("--saved-model-dir", default=None,
                   help="also keep the exported program here")
    p.add_argument("--no-optimize", action="store_true",
                   help="accepted for the JAX script's flag and ignored: a "
                        "float package has no counterpart of TFLite's "
                        "weight quantization")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.export import export_package
    from deepvision_tpu_torch.core.gan import CycleGANTrainer

    trainer = CycleGANTrainer(get_config("cyclegan"), workdir=args.workdir,
                              device=args.device)
    if trainer.resume() is None:
        print("WARNING: no checkpoint found — exporting random weights")
    out = args.output or f"{args.direction}.pt2"
    try:
        export_package(trainer.generators[args.direction],
                       (args.image_size, args.image_size, 3), out,
                       saved_model_dir=args.saved_model_dir,
                       name=f"cyclegan-{args.direction}")
    finally:
        trainer.close()
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")
    return out


if __name__ == "__main__":
    main()
