#!/usr/bin/env python
"""Train U-Net semantic segmentation with the PyTorch port on an NVIDIA GPU
— `python train.py -m unet_resnet50|unet_synthetic|unet_digits
[-c latest]`.

For example, three steps of the ResNet-50 U-Net at its full 224 px with
the paired augmentation on the card:

    python UNet/torch/train.py -m unet_resnet50 --synthetic \
        --image-size 224 --device-augment --steps-per-epoch 3 --epochs 1

`--synthetic` trains on a 64 px canvas unless `--image-size` says
otherwise; `-m unet_digits` trains on segmentation scenes of
scikit-learn's bundled digits. `-m unet_synthetic_sp2` (a spatial mesh)
is refused by name until the port carries spatial parallelism.
`--device cpu` runs on the CPU; without it a host with no card raises.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.cli import run_segmentation  # noqa: E402

MODELS = ["unet_resnet50", "unet_synthetic", "unet_synthetic_sp2",
          "unet_digits"]

if __name__ == "__main__":
    run_segmentation("UNet", MODELS)
