#!/usr/bin/env python
"""Train ShuffleNet models with the PyTorch port on an NVIDIA GPU —
`python train.py -m <model> [-c latest] [--synthetic]`.

For example, three steps of `shufflenet_v1` at its config's resolution on
synthetic data:

    python ShuffleNet/torch/train.py -m shufflenet_v1 --synthetic \\
        --steps-per-epoch 3 --epochs 1

`--device cpu` runs on the CPU (`--image-size 32` keeps that quick);
without it a host with no card raises.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.cli import run_classification  # noqa: E402

MODELS = ["shufflenet_v1"]

if __name__ == "__main__":
    run_classification("ShuffleNet", MODELS)
