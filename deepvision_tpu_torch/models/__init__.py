"""Model zoo of the port — importing this package registers its models in
MODELS (only the ViT family so far)."""

from __future__ import annotations

from typing import Optional

import torch

from . import vit  # noqa: F401
from ..utils.registry import MODELS


def build_model(config, *,
                generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Construct the module a config describes: its model_kwargs plus the
    class count, compute dtype and input geometry (the counterpart of
    deepvision_tpu/core/trainer.py::build_model_from_config). The weights
    are drawn from `generator` (a fresh one seeded with `config.seed` when
    None), on the CPU in f32."""
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    return MODELS.get(config.model)(
        num_classes=config.data.num_classes,
        dtype=getattr(torch, config.dtype),
        image_size=config.data.image_size,
        channels=config.data.channels, generator=generator,
        **config.model_kwargs)
