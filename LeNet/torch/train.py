#!/usr/bin/env python
"""Train LeNet-5 with the PyTorch port —
`python train.py -m lenet5|lenet5_digits [-c latest] [--synthetic]`.

For example, LeNet-5 on scikit-learn's bundled handwritten digits on the
CPU, or a few steps on synthetic data on the card:

    python LeNet/torch/train.py -m lenet5_digits --device cpu
    python LeNet/torch/train.py -m lenet5 --synthetic --steps-per-epoch 3 \\
        --epochs 1

`lenet5` reads the MNIST idx files from `--data-dir` (default
dataset/mnist). Without `--device cpu` a host with no card raises.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.cli import run_classification  # noqa: E402

MODELS = ["lenet5", "lenet5_digits"]

if __name__ == "__main__":
    run_classification("LeNet", MODELS)
