#!/usr/bin/env python
"""Train ViT models with the PyTorch port on an NVIDIA GPU —
`python train.py -m vit_tiny|vit_small [-c latest] [--synthetic]`.

For example, three steps of ViT-Small/16 at its full width and batch on
synthetic data:

    python ViT/torch/train.py -m vit_small --synthetic --batch-size 256 \\
        --steps-per-epoch 3 --epochs 1

Every forward pass launches the flash-attention kernel once per block;
the backward is the naive VJP. `--device cpu` runs on the CPU (the
kernel's plain version); without it a host with no card raises.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.cli import run_classification  # noqa: E402

MODELS = ["vit_tiny", "vit_small"]

if __name__ == "__main__":
    run_classification("ViT", MODELS)
