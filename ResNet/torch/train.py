#!/usr/bin/env python
"""Train ResNets with the PyTorch port on an NVIDIA GPU —
`python train.py -m <model> [-c latest] [--synthetic]`.

For example, three steps of the ResNet-50 large-batch recipe (EMA weights,
no decay on 1-D tensors) at batch 256 on synthetic uint8 data augmented on
the card:

    python ResNet/torch/train.py -m resnet50_tpu --synthetic \\
        --device-augment --batch-size 256 --steps-per-epoch 3 --epochs 1

`--device cpu` runs on the CPU (`--image-size 32` keeps that quick);
without it a host with no card raises.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.cli import run_classification  # noqa: E402

MODELS = ["resnet34", "resnet50", "resnet101", "resnet152", "resnet50v2",
          "resnet50_tpu"]

if __name__ == "__main__":
    run_classification("ResNet", MODELS)
