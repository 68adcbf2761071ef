#!/usr/bin/env python
"""Train Inception models with the PyTorch port on an NVIDIA GPU —
`python train.py -m <model> [-c latest] [--synthetic]`.

For example, three steps of `inception_v3` at its config's resolution on
synthetic data:

    python Inception/torch/train.py -m inception_v3 --synthetic \\
        --steps-per-epoch 3 --epochs 1

`--device cpu` runs on the CPU (`--image-size 96` keeps `inception_v1`
quick, `--image-size 107` `inception_v3`: its aux head needs at least
107 px in train mode); without it a host with no card raises.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from deepvision_tpu_torch.cli import run_classification  # noqa: E402

MODELS = ["inception_v1", "inception_v3"]

if __name__ == "__main__":
    run_classification("Inception", MODELS)
