"""Typed configs: the fields of deepvision_tpu/core/config.py that the serve
path reads (own copy). The training fields (optimizer, schedule, epochs,
data pipeline) arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

# Canonical ImageNet channel statistics in [0,1] units (torchvision
# convention), the defaults of DataConfig.mean/std as in the JAX package.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass
class DataConfig:
    image_size: int = 224
    channels: int = 3               # input channels (1 for MNIST-family)
    num_classes: int = 1000
    # Ship raw uint8 pixels to the device and normalize ((x/255-mean)/std)
    # there instead of on the host (core/steps.normalize_input).
    normalize_on_device: bool = False
    mean: Tuple[float, ...] = IMAGENET_MEAN
    std: Tuple[float, ...] = IMAGENET_STD


@dataclasses.dataclass
class TrainConfig:
    name: str = "model"
    model: str = "resnet50"
    # Trainer family this config belongs to: classification | detection |
    # pose | centernet | gan (only classification is served by the port yet).
    family: str = "classification"
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    dtype: str = "bfloat16"         # compute dtype; params stay f32
    seed: int = 0
