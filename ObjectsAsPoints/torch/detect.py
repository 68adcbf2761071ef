#!/usr/bin/env python
"""CenterNet inference with the PyTorch port: restore a workdir's weights,
detect objects in images, print the boxes. Peak picking (a 3x3 max-pool
test and top-k) replaces NMS. Usage:

    python ObjectsAsPoints/torch/detect.py --workdir runs/centernet img1.jpg ...

Images are resized to `--image-size` (the config's by default) and run
in fixed chunks of 8 (the last one zero-padded): one batch shape however
many images are passed. Each image prints `<path>: N detections`, then
one line per detection at or above `--score-thresh`, `  <class name>
score=… box=(x1,y1,x2,y2)` in normalized corners. PIL decodes the images
and is imported only when they are loaded. `--device cpu` runs on the
CPU; without it a host with no card raises.
"""
import argparse
import os
import sys
from typing import List, Sequence

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

CHUNK = 8
MODELS = ["centernet", "objects_as_points", "centernet_digits"]


def load_images(paths: Sequence[str], size: int) -> np.ndarray:
    """(CHUNK, size, size, 3) f32 in [-1, 1]: the images at `paths` (at most
    CHUNK), resized, then zero rows."""
    from PIL import Image

    batch = np.zeros((CHUNK, size, size, 3), np.float32)
    for j, path in enumerate(paths):
        img = Image.open(path).convert("RGB").resize((size, size))
        batch[j] = np.asarray(img, np.float32) / 127.5 - 1.0
    return batch


def detection_lines(predict, state, batch: np.ndarray, paths: Sequence[str],
                    names: Sequence[str], score_thresh: float) -> List[str]:
    """The output lines of one chunk: `predict(state, images)` on `batch`
    (on the state's device), then the lines of its first len(paths)
    images, each keeping the detections scored at or above
    `score_thresh` (the scores descend)."""
    import torch

    device = next(state.model.parameters()).device
    boxes, scores, classes = (
        t.cpu().numpy() for t in predict(state,
                                         torch.from_numpy(batch).to(device)))
    lines = []
    for i, path in enumerate(paths):
        n = int((scores[i] >= score_thresh).sum())
        lines.append(f"{path}: {n} detections")
        for d in range(n):
            x1, y1, x2, y2 = boxes[i, d]
            lines.append(f"  {names[int(classes[i, d])]} "
                         f"score={float(scores[i, d]):.3f} "
                         f"box=({x1:.3f},{y1:.3f},{x2:.3f},{y2:.3f})")
    return lines


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model", default="centernet", choices=MODELS)
    p.add_argument("--workdir", default=None,
                   help="training workdir holding ckpt/ (default "
                        "runs/<model>)")
    p.add_argument("--score-thresh", type=float, default=0.3)
    p.add_argument("--max-detections", type=int, default=100)
    p.add_argument("--image-size", type=int, default=None,
                   help="inference resolution (default: the config's)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("images", nargs="+")
    args = p.parse_args(argv)

    import torch

    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.centernet import (
        CenterNetTrainer, make_centernet_predict_step)
    from deepvision_tpu_torch.data.class_names import names_for

    cfg = get_config(args.model)
    trainer = CenterNetTrainer(
        cfg, device=args.device,
        workdir=args.workdir or os.path.join("runs", cfg.name))
    trainer.init_state()
    if trainer.resume() is None:
        print("WARNING: no checkpoint found — using random weights")
    predict = make_centernet_predict_step(
        compute_dtype=getattr(torch, cfg.dtype),
        max_detections=args.max_detections)
    names = names_for(cfg.data.num_classes)
    size = args.image_size or cfg.data.image_size
    for start in range(0, len(args.images), CHUNK):
        paths = args.images[start:start + CHUNK]
        for line in detection_lines(predict, trainer.state,
                                    load_images(paths, size), paths, names,
                                    args.score_thresh):
            print(line)
    trainer.close()


if __name__ == "__main__":
    main()
