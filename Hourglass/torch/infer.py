#!/usr/bin/env python
"""Stacked Hourglass pose inference with the PyTorch port: restore a
workdir's weights, predict the 16 MPII keypoints of each image, print
them and, with `--out-dir`, save skeleton overlays. Usage:

    python Hourglass/torch/infer.py --workdir runs/hourglass104 img1.jpg ...

Each image prints `<path>:`, then one line per joint, `  <joint> x=… y=…
conf=…` in normalized coordinates (the last stack's heatmap peak; conf is
its height, 12 at a trained joint), marked `(low conf)` below
`--conf-thresh`. PIL decodes and draws, imported only when images are
loaded. `--device cpu` runs on the CPU; without it a host with no card
raises.
"""
import argparse
import os
import sys
from typing import List, Sequence

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# MPII joint order and limbs (`Datasets/MPII/tfrecords_mpii.py`)
SKELETON = [(0, 1), (1, 2), (2, 6), (3, 6), (3, 4), (4, 5), (6, 7), (7, 8),
            (8, 9), (10, 11), (11, 12), (12, 7), (13, 7), (13, 14), (14, 15)]


def load_images(paths: Sequence[str], size: int) -> np.ndarray:
    """(len(paths), size, size, 3) f32 in [-1, 1]: the images resized."""
    from PIL import Image

    return np.stack([
        np.asarray(Image.open(f).convert("RGB").resize((size, size)),
                   np.float32) / 127.5 - 1.0 for f in paths])


def predict_keypoints(state, batch: np.ndarray):
    """(kp_x, kp_y, conf), each (B, K) numpy: the last stack's heatmaps
    decoded per joint, from the inference-mode forward on the state's
    device and EMA weights when it keeps them."""
    import torch

    from deepvision_tpu_torch.ops.heatmap import decode_keypoints

    model = state.model
    device = next(model.parameters()).device
    with state.ema_weights(), torch.inference_mode():
        model.eval()
        heads = model(torch.from_numpy(batch).to(device))[-1]
        return tuple(t.cpu().numpy() for t in decode_keypoints(heads))


def keypoint_lines(kp_x, kp_y, conf, paths: Sequence[str],
                   conf_thresh: float) -> List[str]:
    """The printed lines of each image's joints."""
    from deepvision_tpu_torch.core.eval_pose import MPII_JOINT_NAMES

    lines = []
    for i, path in enumerate(paths):
        lines.append(f"{path}:")
        for j, name in enumerate(MPII_JOINT_NAMES[:kp_x.shape[1]]):
            mark = "" if conf[i, j] >= conf_thresh else "  (low conf)"
            lines.append(f"  {name:12s} x={kp_x[i, j]:.3f} "
                         f"y={kp_y[i, j]:.3f} conf={conf[i, j]:.2f}{mark}")
    return lines


def save_overlay(path: str, kp_x, kp_y, visible, size: int,
                 out_dir: str) -> str:
    """The image at `path` resized, its skeleton drawn; returns the file."""
    from PIL import Image, ImageDraw

    img = Image.open(path).convert("RGB").resize((size, size))
    draw = ImageDraw.Draw(img)
    pts = [(float(x) * size, float(y) * size) for x, y in zip(kp_x, kp_y)]
    for a, b in SKELETON:
        if a < len(pts) and b < len(pts) and visible[a] and visible[b]:
            draw.line([pts[a], pts[b]], width=3, fill=(0, 255, 0))
    for j, (x, y) in enumerate(pts):
        if visible[j]:
            draw.ellipse([x - 3, y - 3, x + 3, y + 3], fill=(255, 0, 0))
    name = os.path.join(
        out_dir, f"{os.path.splitext(os.path.basename(path))[0]}_pose.png")
    img.save(name)
    return name


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="runs/hourglass104")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--conf-thresh", type=float, default=1.0,
                   help="min peak height (heatmaps train to 12 at joints)")
    p.add_argument("--out-dir", default=None,
                   help="save skeleton overlays here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("images", nargs="+")
    args = p.parse_args(argv)

    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.pose import PoseTrainer

    trainer = PoseTrainer(get_config("hourglass104"), device=args.device,
                          workdir=args.workdir)
    trainer.init_state()
    if trainer.resume() is None:
        print("WARNING: no checkpoint found — using random weights")
    kp_x, kp_y, conf = predict_keypoints(
        trainer.state, load_images(args.images, args.image_size))
    trainer.close()
    for line in keypoint_lines(kp_x, kp_y, conf, args.images,
                               args.conf_thresh):
        print(line)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        for i, path in enumerate(args.images):
            saved = save_overlay(path, kp_x[i], kp_y[i],
                                 conf[i] >= args.conf_thresh,
                                 args.image_size, args.out_dir)
            print(f"saved {saved}")


if __name__ == "__main__":
    main()
