#!/usr/bin/env python
"""DCGAN inference with the PyTorch port: restore the checkpoint, sample
digits, save a PNG grid (`DCGAN/jax/inference.py`'s flags, plus
`--device`). Pillow writes the PNG; it is imported only here, and its
absence raises a named error.

    python DCGAN/torch/inference.py --workdir runs/dcgan --num 16
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="runs/dcgan")
    p.add_argument("--num", type=int, default=16)
    p.add_argument("--out", default="generated.png")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.gan import DCGANTrainer
    from deepvision_tpu_torch.tools.gan_images import load_pil, tile_grid

    image = load_pil()
    trainer = DCGANTrainer(get_config("dcgan"), workdir=args.workdir,
                           device=args.device)
    if trainer.resume() is None:
        print("WARNING: no checkpoint found — sampling from random weights")
    images = trainer.generate(args.num, args.seed)
    trainer.close()
    image.fromarray(tile_grid(images)).save(args.out)
    print(f"saved {args.num} samples to {args.out}")


if __name__ == "__main__":
    main()
