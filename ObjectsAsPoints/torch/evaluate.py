#!/usr/bin/env python
"""CenterNet accuracy evaluation with the PyTorch port: COCO mAP@[.5:.95]
or VOC mAP@0.5 of a trained workdir's weights. Usage:

    # the held-out digits_detect scenes
    python ObjectsAsPoints/torch/evaluate.py -m centernet_digits \
        --workdir runs/centernet_digits --metric voc --device cpu
    # the VOC/COCO val* TFRecords (the ragged last batch kept)
    python ObjectsAsPoints/torch/evaluate.py --data-dir dataset/tfrecords
    # smoke: random weights
    python ObjectsAsPoints/torch/evaluate.py -m centernet --synthetic

The weights are the workdir's checkpoint (`-c`, latest by default), its
EMA weights when it kept them. `--synthetic` evaluates random weights on
2 synthetic batches of 2 at 128 px. The TFRecord split decodes on the
card (data/detection.py) and carries the VOC difficult flags;
`--image-size` (not a JAX flag) evaluates at another size. `--device cpu`
runs on the CPU; without it a host with no card raises.
"""
import argparse
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

MODELS = ["centernet", "objects_as_points", "centernet_digits"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model", default="centernet", choices=MODELS)
    p.add_argument("-c", "--checkpoint", default="latest",
                   help="epoch number or 'latest'")
    p.add_argument("--workdir", default=None)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--image-size", type=int, default=None,
                   help="override the config's image size (records only)")
    p.add_argument("--metric", default="coco",
                   choices=["coco", "voc", "voc07"])
    p.add_argument("--score-thresh", type=float, default=0.05)
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate random weights on synthetic batches "
                        "(smoke test)")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--out", default=None,
                   help="also write the metrics dict as JSON")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.centernet import (CenterNetTrainer,
                                                     evaluate_map)

    cfg = get_config(args.model)
    if args.image_size:
        import dataclasses
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, image_size=args.image_size))
    if args.synthetic:
        from deepvision_tpu_torch.data.detection import synthetic_batches
        size = 128
        batches = synthetic_batches(batch_size=2, image_size=size,
                                    num_classes=cfg.data.num_classes,
                                    steps=2)
    elif cfg.data.dataset == "digits_detect":
        # the held-out scenes the training CLI validates on
        from deepvision_tpu_torch.data.digits import (detection_batches,
                                                      detection_val_scenes)
        size = cfg.data.image_size
        va = detection_val_scenes(canvas=size,
                                  n_scenes=cfg.data.val_examples)
        batches = detection_batches(va, batch_size=cfg.batch_size)
    else:
        # the val split with its ragged tail and the difficult flags
        from deepvision_tpu_torch.data.detection import build_dataset
        from deepvision_tpu_torch.utils.device import resolve_device
        data_dir = args.data_dir or cfg.data.data_dir or "dataset/tfrecords"
        batches = iter(build_dataset(
            os.path.join(data_dir, "val*"), batch_size=cfg.batch_size,
            image_size=cfg.data.image_size, training=False,
            with_difficult=True, drop_remainder=False,
            device=resolve_device(args.device)))
    if args.max_batches:
        batches = itertools.islice(batches, args.max_batches)

    trainer = CenterNetTrainer(
        cfg, device=args.device,
        workdir=args.workdir or os.path.join("runs", cfg.name))
    trainer.init_state()
    if not args.synthetic and trainer.resume(
            None if args.checkpoint == "latest"
            else int(args.checkpoint)) is None:
        print("WARNING: no checkpoint found — evaluating random weights")

    metrics = evaluate_map(trainer.state, batches,
                           num_classes=cfg.data.num_classes,
                           metric=args.metric, score_thresh=args.score_thresh)
    trainer.close()
    for k in sorted(metrics):
        if k.startswith("mAP"):
            print(f"{k}: {metrics[k]:.4f}")
    if args.out:
        with open(args.out, "w") as fp:
            json.dump({k: float(v) for k, v in metrics.items()}, fp,
                      indent=1, sort_keys=True)
            fp.write("\n")
    return metrics


if __name__ == "__main__":
    main()
