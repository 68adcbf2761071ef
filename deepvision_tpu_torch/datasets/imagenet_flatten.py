"""The flat-directory ImageNet layout for `data/imagenet_flat.py` (own copy
of `Datasets/ILSVRC2012/flatten.py`): the per-synset train directories
flattened into one directory of `<synset>_<name>.JPEG` files, and the
validation JPEGs renamed to carry their synset (from the validation
labels file). Hard links by default, `--copy` where links are not
available; files are placed as they are (no image is decoded).

    python -m deepvision_tpu_torch.datasets.imagenet_flatten \\
        --train-dir dataset/train --out dataset/train_flatten
    python -m deepvision_tpu_torch.datasets.imagenet_flatten \\
        --val-dir dataset/validation \\
        --val-labels imagenet_2012_validation_synset_labels.txt \\
        --out dataset/val_flatten
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys


def _place(src: str, dst: str, copy: bool) -> None:
    if os.path.exists(dst):
        return
    if copy:
        shutil.copy2(src, dst)
    else:
        os.link(src, dst)


def flatten_train(train_dir: str, out: str, copy: bool) -> int:
    """train/<synset>/<name>.JPEG → out/<synset>_<name>.JPEG (a name that
    already carries its synset prefix keeps it)."""
    os.makedirs(out, exist_ok=True)
    n = 0
    for synset in sorted(os.listdir(train_dir)):
        d = os.path.join(train_dir, synset)
        if not (os.path.isdir(d) and synset.startswith("n")):
            continue
        for fname in os.listdir(d):
            flat = fname if fname.startswith(synset) else f"{synset}_{fname}"
            _place(os.path.join(d, fname), os.path.join(out, flat), copy)
            n += 1
    return n


def flatten_val(val_dir: str, labels_path: str, out: str, copy: bool) -> int:
    """validation/ILSVRC2012_val_0000XXXX.JPEG and line XXXX's synset →
    out/<synset>_val_0000XXXX.JPEG (the name → label convention of the
    flat loader)."""
    with open(labels_path) as fp:
        labels = [line.strip() for line in fp if line.strip()]
    files = sorted(f for f in os.listdir(val_dir)
                   if f.upper().endswith((".JPEG", ".JPG")))
    if len(files) != len(labels):
        sys.exit(f"ERROR: {len(files)} val images but {len(labels)} labels")
    os.makedirs(out, exist_ok=True)
    for fname, synset in zip(files, labels):
        stem = fname.split(".")[0].replace("ILSVRC2012_", "")
        _place(os.path.join(val_dir, fname),
               os.path.join(out, f"{synset}_{stem}.JPEG"), copy)
    return len(files)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Flatten ImageNet for the flat-directory loader")
    p.add_argument("--train-dir", help="untarred train/ (per-synset subdirs)")
    p.add_argument("--val-dir", help="untarred validation/ (flat JPEGs)")
    p.add_argument("--val-labels",
                   help="imagenet_2012_validation_synset_labels.txt")
    p.add_argument("--out", required=True)
    p.add_argument("--copy", action="store_true",
                   help="copy instead of hard-linking")
    args = p.parse_args(argv)

    if args.train_dir:
        n = flatten_train(args.train_dir, args.out, args.copy)
    elif args.val_dir:
        if not args.val_labels:
            sys.exit("--val-dir requires --val-labels")
        n = flatten_val(args.val_dir, args.val_labels, args.out, args.copy)
    else:
        sys.exit("pass --train-dir or --val-dir")
    print(f"placed {n} files into {args.out}")
    return n


if __name__ == "__main__":
    main()
