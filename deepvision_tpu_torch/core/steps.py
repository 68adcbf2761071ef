"""Input normalization shared by every predict path (own copy of
deepvision_tpu/core/steps.py::_normalize_input)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def normalize_input(images: torch.Tensor,
                    input_norm: Optional[Tuple[Sequence[float],
                                               Sequence[float]]],
                    compute_dtype: torch.dtype) -> torch.Tensor:
    """Cast to the compute dtype; with `input_norm=(mean, std)` the images
    are raw [0,255] pixels (uint8 transfer) normalized here on the device
    instead of on the host. Division and subtraction happen in f32 so uint8
    pixel values stay exact, then the result drops to the compute dtype
    once."""
    if input_norm is None:
        return images.to(compute_dtype)
    mean, std = input_norm
    mean = torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=images.device)
    images = images.to(torch.float32) / 255.0
    return ((images - mean) / std).to(compute_dtype)
