#!/usr/bin/env python
"""Train the Stacked Hourglass with the PyTorch port on an NVIDIA GPU —
`python train.py -m hourglass104 [-c latest]`.

For example, two steps at the full 256 px on synthetic keypoints:

    python Hourglass/torch/train.py -m hourglass104 --synthetic \
        --image-size 256 --batch-size 32 --steps-per-epoch 2 --epochs 1

`--synthetic` trains on a 64 px canvas unless `--image-size` says
otherwise; the MPII TFRecord pipeline is not ported yet. `--device cpu`
runs on the CPU; without it a host with no card raises.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.cli import run_pose  # noqa: E402

MODELS = ["hourglass104"]

if __name__ == "__main__":
    run_pose("Hourglass", MODELS)
