"""Import a reference Keras `save_weights` h5 checkpoint into the port's
checkpoint format (own copy of tools/import_keras_checkpoint.py).

    python -m deepvision_tpu_torch.tools.import_keras_checkpoint \\
        -m yolov3 --h5 yolov3_best.h5 --workdir runs/yolov3 [--epoch 40]

The h5 is read by the port's own HDF5 reader (utils/h5.py: h5py's
default layout; chunked or compressed data, `libver="latest"` files and
new-style groups are refused by name). yolov3 and yolov3_voc map the
reference's explicitly named layers through utils/keras_convert.py;
hourglass104's auto-named layers (`conv2d_37`, ...) pair with the
model's modules by call order (utils/order_convert.py), the model built
with the workdir's `model_kwargs.json` pins. Every leaf is checked
against the model built on `--device` (the card by default): an h5 that
does not fit (an 80-class COCO h5 given to `-m yolov3_voc`) exits with
the leaf named. The model is saved as epoch `--epoch` by the trainer's
CheckpointManager, with its integrity manifest and `imported_from` in
the host state, so `YOLO/torch/train.py -c latest`, `detect.py`,
`evaluate.py` and `serve --workdir` take it.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

CHOICES = ["yolov3", "yolov3_voc", "hourglass104"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Import a reference Keras save_weights h5 checkpoint")
    p.add_argument("-m", "--model", required=True, choices=CHOICES)
    p.add_argument("--h5", required=True,
                   help="Keras save_weights file (legacy TF2 h5 layout)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--epoch", type=int, default=0,
                   help="epoch number to record (the reference encodes it "
                        "in the filename, train.py:300-304)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu: "
                        "where the model is built and the weights loaded")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns {"workdir", "epoch"}."""
    args = build_parser().parse_args(argv)

    import torch

    from ..configs import get_config
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.model)
    workdir = args.workdir or os.path.join("runs", cfg.name)
    if args.model == "hourglass104":
        from ..core.pose import PoseTrainer
        from ..utils import order_convert

        trainer = PoseTrainer(cfg, device=device, workdir=workdir)
    else:
        from ..core.detection import DetectionTrainer
        from ..utils import keras_convert

        trainer = DetectionTrainer(cfg, device=device, workdir=workdir)
    try:
        trainer.init_state()
        cfg = trainer.config                     # with the workdir's pins
        try:
            if args.model == "hourglass104":
                size = cfg.data.image_size
                sample = torch.zeros((1, size, size, cfg.data.channels),
                                     device=device)
                layers = order_convert.layers_from_legacy_h5(args.h5)
                weights = order_convert.convert_by_call_order(
                    trainer.model, layers, sample)
            else:
                weights = keras_convert.to_state_dict(
                    args.model, keras_convert.load_h5_weights(args.h5),
                    trainer.model)
        except (ValueError, KeyError, NotImplementedError) as e:
            # a yolo h5 given to hourglass104 (explicitly named layers), a
            # full-model save, or a leaf of another shape: the offending
            # name is in the message
            raise SystemExit(f"{args.h5} does not fit {args.model}: {e}")
        trainer.model.load_state_dict(weights, strict=False)
        if trainer.state.ema is not None:   # the average starts at them
            trainer.state.ema = [p.detach().clone()
                                 for p in trainer.model.parameters()]
        trainer.ckpt.save(args.epoch, trainer.state.state_dict(),
                          host_state={"imported_from": args.h5})
    finally:
        trainer.close()
    print(f"imported epoch {args.epoch} from {args.h5} into {workdir}")
    return {"workdir": workdir, "epoch": args.epoch}


if __name__ == "__main__":
    main()
