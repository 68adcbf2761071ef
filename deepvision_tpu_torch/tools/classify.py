"""Single-image classification from a trained checkpoint (own copy of
tools/classify.py): the script form of the demo notebooks' `predict()`
cell, over `core/classify.py::Classifier`.

    python -m deepvision_tpu_torch.tools.classify -m resnet50 \\
        --workdir runs/resnet50 [--class-names indices.json] img1.jpg ...

On the card (the default) a JPEG decodes with nvJPEG; `--device cpu`
decodes with PIL, as the JAX script does.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def _epoch(v: str) -> Optional[int]:
    if v == "latest":
        return None
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an epoch number or 'latest', got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Top-k classes of images from a trained checkpoint")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--workdir", default=None,
                   help="training workdir holding ckpt/ (default "
                        "runs/<model>)")
    p.add_argument("-c", "--checkpoint", default=None, type=_epoch,
                   help="epoch number (default: latest)")
    p.add_argument("--top", type=int, default=5)
    p.add_argument("--class-names", default=None,
                   help="indices.json or one-name-per-line file")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("images", nargs="+")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Prints each image's top-k and returns them, {path: [(name,
    probability), ...]}."""
    args = build_parser().parse_args(argv)
    from ..core.classify import Classifier

    clf = Classifier(args.model, workdir=args.workdir,
                     checkpoint=args.checkpoint,
                     class_names_file=args.class_names, device=args.device)
    try:
        if clf.epoch is None:
            raise SystemExit(
                f"no checkpoint found under "
                f"{args.workdir or os.path.join('runs', args.model)!r}")
        out = {}
        for path in args.images:
            print(path)
            out[path] = clf.predict(path, top=args.top)
            for name, prob in out[path]:
                print(f"  {prob:6.2%}  {name}")
        return out
    finally:
        clf.close()


if __name__ == "__main__":
    main()
