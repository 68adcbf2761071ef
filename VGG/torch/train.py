#!/usr/bin/env python
"""Train VGG models with the PyTorch port on an NVIDIA GPU —
`python train.py -m <model> [-c latest] [--synthetic]`.

For example, three steps of `vgg16` at its config's resolution on
synthetic data:

    python VGG/torch/train.py -m vgg16 --synthetic \\
        --steps-per-epoch 3 --epochs 1

`--device cpu` runs on the CPU (`--image-size 32` keeps that quick);
without it a host with no card raises.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.cli import run_classification  # noqa: E402

MODELS = ["vgg16", "vgg19"]

if __name__ == "__main__":
    run_classification("VGG", MODELS)
