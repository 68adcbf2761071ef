"""CelebA split into male (trainA) and female (trainB) domains by the
`Male` attribute (own copy of `CycleGAN/jax/celeba.py`); the images are
copied as they are, for `datasets/cyclegan.py` to convert.

    python -m deepvision_tpu_torch.datasets.celeba \\
        --attrs list_attr_celeba.txt --images img_align_celeba \\
        --out datasets/celeba
"""

from __future__ import annotations

import argparse
import os
from shutil import copyfile


def split_by_gender(attrs: str, images: str, out: str) -> dict:
    """Copy every image listed in `attrs` into out/trainA (male) or
    out/trainB; {split: count}."""
    os.makedirs(os.path.join(out, "trainA"), exist_ok=True)  # male
    os.makedirs(os.path.join(out, "trainB"), exist_ok=True)  # female
    n = {"trainA": 0, "trainB": 0}
    with open(attrs) as fp:
        fp.readline()                      # count line
        header = fp.readline().split()
        male_col = header.index("Male")
        for line in fp:
            parts = line.split()
            if not parts:
                continue
            filename = parts[0]
            gender = int(parts[1 + male_col])
            dst = "trainA" if gender == 1 else "trainB"
            copyfile(os.path.join(images, filename),
                     os.path.join(out, dst, filename))
            n[dst] += 1
    print(f"male (trainA): {n['trainA']}, female (trainB): {n['trainB']}")
    return n


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="Split CelebA into male/female CycleGAN domains")
    p.add_argument("--attrs", default="./list_attr_celeba.txt")
    p.add_argument("--images", default="./img_align_celeba")
    p.add_argument("--out", default="./datasets/celeba")
    args = p.parse_args(argv)
    return split_by_gender(args.attrs, args.images, args.out)


if __name__ == "__main__":
    main()
