#!/usr/bin/env python
"""Train AlexNet models with the PyTorch port on an NVIDIA GPU —
`python train.py -m <model> [-c latest] [--synthetic]`.

For example, three steps of `alexnet1` at its config's resolution on
synthetic data:

    python AlexNet/torch/train.py -m alexnet1 --synthetic \\
        --steps-per-epoch 3 --epochs 1

`--device cpu` runs on the CPU (`--image-size 67` keeps that quick: the
smallest size whose last pool has an output is 63 px); without it a host
with no card raises.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.cli import run_classification  # noqa: E402

MODELS = ["alexnet1", "alexnet2"]

if __name__ == "__main__":
    run_classification("AlexNet", MODELS)
