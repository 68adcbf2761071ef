"""Model zoo of the port — importing this package registers its models in
MODELS (the ViT, YOLO V3, LeNet-5, ResNet, AlexNet, VGG, Inception,
MobileNet, ShuffleNet, Stacked Hourglass, CenterNet, U-Net segmentation
and GAN families)."""

from __future__ import annotations

import inspect
from typing import Optional

import torch

from . import (alexnet, centernet, gan, hourglass,  # noqa: F401
               inception, lenet, mobilenet, resnet, segment, shufflenet,
               vgg, vit, yolo)
from ..utils.registry import MODELS


def build_model(config, *,
                generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Construct the module a config describes: its model_kwargs plus, for
    each that the constructor takes and model_kwargs does not set, the
    class count, compute dtype and input geometry (the counterpart of
    deepvision_tpu/core/trainer.py::build_model_from_config). The weights
    are drawn from `generator` (a fresh one seeded with `config.seed` when
    None), on the CPU in f32. A pose model takes the class count as
    `num_heatmap` (the JAX trainers' `num_classes_kwarg`)."""
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    ctor = MODELS.get(config.model)
    accepted = inspect.signature(ctor).parameters
    offered = {"num_classes": config.data.num_classes,
               "num_heatmap": config.data.num_classes,
               "dtype": getattr(torch, config.dtype),
               "image_size": config.data.image_size,
               "channels": config.data.channels, "generator": generator}
    kwargs = dict(config.model_kwargs)
    for name, value in offered.items():
        if name in accepted:
            kwargs.setdefault(name, value)
    return ctor(**kwargs)
