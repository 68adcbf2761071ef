"""Import a reference PyTorch checkpoint into the port's checkpoint format
(own copy of tools/import_torch_checkpoint.py).

    python -m deepvision_tpu_torch.tools.import_torch_checkpoint \\
        -m resnet50 --torch-ckpt resnet50-yanjiali-012320.pt \\
        --workdir runs/resnet50

Loads the `.pt` dict (`ResNet/pytorch/train.py:417-428` format, or a bare
state_dict) with `weights_only=True`; a file that needs full unpickling is
refused unless `--allow-pickle`. The weights map through
utils/torch_convert.py (the JAX importer's trees, then the port's module
names) into the model built on `--device` (the card by default), the
architecture pins go to the workdir's `model_kwargs.json`
(stride on the bottlenecks' conv1, the reference resnet34's depth and
projections, Inception V1 without BatchNorm), and the model is saved as
the checkpoint's epoch by the trainer's CheckpointManager, with its
integrity manifest and `imported_from` in the host state: `serve
--workdir` and `train.py -c latest` take it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
from typing import Optional, Sequence

CHOICES = ["resnet34", "resnet50", "resnet101", "resnet152", "vgg16",
           "vgg19", "alexnet1", "alexnet2", "mobilenet_v1", "inception_v1",
           "lenet5"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Import a reference PyTorch checkpoint")
    p.add_argument("-m", "--model", required=True, choices=CHOICES)
    p.add_argument("--torch-ckpt", required=True)
    p.add_argument("--workdir", default=None)
    p.add_argument("--image-size", type=int, default=None,
                   help="sample input edge for model init (default: the "
                        "model config's image size)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu: "
                        "where the model is built and the weights loaded")
    p.add_argument("--allow-pickle", action="store_true",
                   help="permit full unpickling of non-weights-only "
                        "checkpoints (runs arbitrary code; trusted files "
                        "only)")
    return p


def architecture_pins(model: str, state_dict) -> dict:
    """The model kwargs under which the port's model computes the
    reference's function (the JAX importer's pins)."""
    from ..utils.torch_convert import infer_basic_stage_sizes
    if model == "resnet34":
        # depth follows the weights (the reference's resnet34.py builds 2
        # blocks a stage); block 0 of every stage projects
        return {"stage_sizes": list(infer_basic_stage_sizes(state_dict)),
                "project_first_blocks": True}
    if model.startswith("resnet"):
        return {"stride_on_first": True}
    if model == "inception_v1":
        return {"use_bn": False}
    return {}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns {"workdir", "epoch", "pins"}."""
    args = build_parser().parse_args(argv)

    import torch

    from ..configs import get_config
    from ..core.trainer import Trainer
    from ..utils.device import resolve_device
    from ..utils.torch_convert import to_state_dict

    device = resolve_device(args.device)
    try:
        payload = torch.load(args.torch_ckpt, map_location="cpu",
                             weights_only=True)
    except (pickle.UnpicklingError, RuntimeError):
        # the weights-only refusal (non-tensor payloads such as
        # schedulers); other errors (a missing or corrupt file) propagate
        if not args.allow_pickle:
            raise SystemExit(
                f"{args.torch_ckpt} needs full (unsafe) unpickling — pickle "
                "can execute arbitrary code. Re-run with --allow-pickle only "
                "if you trust the file's origin.")
        payload = torch.load(args.torch_ckpt, map_location="cpu",
                             weights_only=False)
    state_dict = (payload.get("model", payload) if isinstance(payload, dict)
                  else payload)
    epoch = int(payload.get("epoch", 0)) if isinstance(payload, dict) else 0

    cfg = get_config(args.model)
    pinned = architecture_pins(args.model, state_dict)
    cfg = cfg.replace(model_kwargs={**cfg.model_kwargs, **pinned})
    if args.image_size:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, image_size=args.image_size))
    workdir = args.workdir or os.path.join("runs", cfg.name)
    os.makedirs(workdir, exist_ok=True)
    # the pins stay with the workdir, so every later run on it (train -c
    # latest, evaluate, serve --workdir) builds the same architecture
    with open(os.path.join(workdir, "model_kwargs.json"), "w") as fp:
        json.dump(pinned, fp)
    trainer = Trainer(cfg, device=device, workdir=workdir)
    try:
        trainer.init_state()
        weights = to_state_dict(args.model, state_dict, trainer.model)
        trainer.model.load_state_dict(weights, strict=False)
        if trainer.state.ema is not None:   # the average starts at them
            trainer.state.ema = [p.detach().clone()
                                 for p in trainer.model.parameters()]
        trainer.ckpt.save(epoch, trainer.state.state_dict(),
                          host_state={"imported_from": args.torch_ckpt})
    finally:
        trainer.close()
    print(f"imported epoch {epoch} from {args.torch_ckpt} into {workdir}")
    return {"workdir": workdir, "epoch": epoch, "pins": pinned}


if __name__ == "__main__":
    main()
