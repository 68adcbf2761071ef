#!/usr/bin/env python
"""Train CenterNet (ObjectsAsPoints) with the PyTorch port on an NVIDIA GPU
— `python train.py -m centernet|objects_as_points|centernet_digits
[-c latest]`.

For example, two steps at the full 256 px on synthetic boxes:

    python ObjectsAsPoints/torch/train.py -m centernet --synthetic \
        --image-size 256 --batch-size 32 --steps-per-epoch 2 --epochs 1

`--synthetic` trains on a 128 px canvas unless `--image-size` says
otherwise; `-m centernet_digits` trains on the digits_detect scenes of
scikit-learn's bundled digits. The VOC/COCO TFRecord pipeline is not
ported yet. `--device cpu` runs on the CPU; without it a host with no
card raises.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.cli import run_centernet  # noqa: E402

MODELS = ["centernet", "objects_as_points", "centernet_digits"]

if __name__ == "__main__":
    run_centernet("ObjectsAsPoints", MODELS)
