#!/usr/bin/env python
"""CycleGAN inference with the PyTorch port: restore the generators,
translate images, save each input beside its translation
(`CycleGAN/jax/inference.py`'s flags, plus `--device`).
Pillow reads and writes the images; it is imported only here, and its
absence raises a named error.

    python CycleGAN/torch/inference.py --workdir runs/cyclegan-x \
        --direction a2b img1.jpg img2.jpg
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="runs/cyclegan")
    p.add_argument("--direction", default="a2b", choices=["a2b", "b2a"])
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--out-dir", default="translated")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("images", nargs="+")
    args = p.parse_args(argv)

    import numpy as np

    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.gan import CycleGANTrainer
    from deepvision_tpu_torch.tools.gan_images import load_pil, side_by_side

    image = load_pil()
    trainer = CycleGANTrainer(get_config("cyclegan"), workdir=args.workdir,
                              device=args.device)
    if trainer.resume() is None:
        print("WARNING: no checkpoint found — using random weights")
    size = args.image_size
    os.makedirs(args.out_dir, exist_ok=True)
    batch = np.stack([
        np.asarray(image.open(f).convert("RGB").resize((size, size)),
                   np.float32) / 127.5 - 1.0 for f in args.images])
    out = trainer.translate(batch, args.direction)
    trainer.close()
    for path, src, dst in zip(args.images, batch, out):
        name = os.path.join(args.out_dir,
                            f"{os.path.splitext(os.path.basename(path))[0]}"
                            f"_{args.direction}.png")
        image.fromarray(side_by_side(src, dst)).save(name)
        print(f"saved {name}")


if __name__ == "__main__":
    main()
