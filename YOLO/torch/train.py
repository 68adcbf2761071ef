#!/usr/bin/env python
"""Train YOLO V3 with the PyTorch port on an NVIDIA GPU —
`python train.py -m yolov3|yolov3_voc|yolov3_digits [-c latest]`.

For example, three steps at the full 416 px on synthetic data:

    python YOLO/torch/train.py -m yolov3 --synthetic --image-size 416 \
        --batch-size 16 --steps-per-epoch 3 --epochs 1

`--device cpu` runs on the CPU (the kernels' plain versions); without it a
host with no card raises.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.cli import run_detection  # noqa: E402

MODELS = ["yolov3", "yolov3_voc", "yolov3_digits"]

if __name__ == "__main__":
    run_detection("YOLO", MODELS)
