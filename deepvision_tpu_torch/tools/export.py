"""Export a trained model of the zoo as a `torch.export` program and/or an
AOTInductor package (own copy of tools/export.py, whose SavedModel and
TFLite roles these take; core/export.py says how they map).

    python -m deepvision_tpu_torch.tools.export -m resnet50 \\
        --workdir runs/resnet50 --saved-model exported/resnet50 \\
        [--tflite resnet50.pt2] [--batch-size 8]

The checkpoint restores as the serving CLI's `--workdir` restores it
(serve/engine.py::load_checkpoint_weights: the workdir's pinned model
kwargs, the EMA weights when the checkpoint keeps them, a verified
restore), the model is cast to its compute dtype and traced on `--device`
(the card by default), so the program and the package run there.
`--saved-model` writes the program's directory, `--tflite` the package
(`--no-optimize` is accepted and ignored: TFLite's weight quantization
has no counterpart in a float package). A workdir with no checkpoint is refused,
as in the JAX tool; a GAN config is refused by name (a CycleGAN generator
exports through CycleGAN/torch/convert.py).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export a trained model as a torch.export program "
                    "and/or an AOTInductor package")
    p.add_argument("-m", "--model", required=True,
                   help="config name (e.g. resnet50, yolov3, hourglass104)")
    p.add_argument("-c", "--checkpoint", default="latest")
    p.add_argument("--workdir", default=None,
                   help="training workdir holding ckpt/ (default "
                        "runs/<model>)")
    p.add_argument("--saved-model", default=None,
                   help="write the exported program to this directory")
    p.add_argument("--tflite", default=None,
                   help="write the AOTInductor package to this path")
    p.add_argument("--image-size", type=int, default=None,
                   help="export resolution (default: the config's)")
    p.add_argument("--batch-size", type=int, default=1,
                   help="static batch dim of the exported signature")
    p.add_argument("--no-optimize", action="store_true",
                   help="accepted for the JAX tool's flag and ignored: a "
                        "float package has no counterpart of TFLite's "
                        "weight quantization")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def restore_model(name: str, workdir: str, checkpoint: str = "latest",
                  image_size: Optional[int] = None, device="cuda"):
    """(eval-mode module cast to its compute dtype on `device`, config,
    restored epoch) of a training workdir; SystemExit when nothing is
    restorable or the config is a GAN."""
    from ..configs import get_config
    from ..serve.engine import load_checkpoint_weights
    from ..utils.device import resolve_device

    if get_config(name).family == "gan":
        raise SystemExit(
            f"config {name!r} is adversarial — export a CycleGAN generator "
            f"with CycleGAN/torch/convert.py")
    device = resolve_device(device)
    model, provenance, cfg = load_checkpoint_weights(
        name, workdir, checkpoint=checkpoint, verbose=False,
        image_size=image_size)
    epoch = provenance["checkpoint_epoch"]
    if epoch is None:
        raise SystemExit(
            f"no checkpoint restorable from {workdir!r} — exporting random "
            f"weights is never what you want (train first, or pass "
            f"--workdir/-c)")
    model = model.eval().cast_compute_weights_().to(device)
    return model, cfg, epoch


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Writes what the flags ask for; returns {"saved_model", "tflite",
    "epoch"}."""
    p = build_parser()
    args = p.parse_args(argv)
    if not (args.saved_model or args.tflite):
        p.error("nothing to do: pass --saved-model and/or --tflite")

    from ..core.export import export_package, export_program

    workdir = args.workdir or os.path.join("runs", args.model)
    model, cfg, epoch = restore_model(args.model, workdir, args.checkpoint,
                                      args.image_size, args.device)
    size = cfg.data.image_size
    shape = (size, size, cfg.data.channels)
    if args.tflite:
        export_package(model, shape, args.tflite,
                       batch_size=args.batch_size,
                       saved_model_dir=args.saved_model, name=cfg.name)
        print(f"wrote {args.tflite}"
              + (f" (program kept at {args.saved_model})"
                 if args.saved_model else ""), flush=True)
    else:
        export_program(model, shape, args.saved_model,
                       batch_size=args.batch_size, name=cfg.name)
        print(f"wrote {args.saved_model}", flush=True)
    return {"saved_model": args.saved_model, "tflite": args.tflite,
            "epoch": epoch}


if __name__ == "__main__":
    main()
