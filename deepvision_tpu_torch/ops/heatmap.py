"""Keypoints -> 2D gaussian heatmaps, and the per-joint argmax decode
(own copy of deepvision_tpu/ops/heatmap.py: `render_gaussian_heatmaps`,
`decode_keypoints`).

A sigma = 1 gaussian of amplitude 12 centred on each rounded keypoint,
truncated at 3 sigma; all zero for a joint that is invisible, negative
(a missing joint) or whose patch lies wholly off the map. Batched here
(the JAX package vmaps one example): the whole (B, H, W, K) tensor is one
broadcast expression, so the train step renders its labels on the device.
`torch.round` rounds half to even, as `jnp.round` does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.common import at_least_f32


def render_gaussian_heatmaps(kp_x: torch.Tensor, kp_y: torch.Tensor,
                             visibility: torch.Tensor, height: int,
                             width: int, sigma: float = 1.0,
                             scale: float = 12.0) -> torch.Tensor:
    """(..., K) keypoints normalized to [0, 1] (< 0: missing) and their
    visibility (0: invisible) -> (..., height, width, K) f32 heatmaps
    (f64 from f64 keypoints)."""
    kp_x, kp_y = at_least_f32(kp_x), at_least_f32(kp_y)
    x0 = torch.round(kp_x * width).to(torch.int32)[..., None, None, :]
    y0 = torch.round(kp_y * height).to(torch.int32)[..., None, None, :]
    dev, dt = kp_x.device, kp_x.dtype
    xs = torch.arange(width, dtype=torch.int32, device=dev)[None, :, None]
    ys = torch.arange(height, dtype=torch.int32, device=dev)[:, None, None]
    dx, dy = xs - x0, ys - y0                       # (..., 1|H, W|1, K)
    r = int(3 * sigma)
    in_patch = (dx.abs() <= r) & (dy.abs() <= r)
    gauss = torch.exp(-(dx.to(dt) ** 2 + dy.to(dt) ** 2)
                      / (2.0 * sigma * sigma)) * scale
    visible = (visibility > 0) & (kp_x >= 0) & (kp_y >= 0)
    on_map = ((x0 - r < width) & (y0 - r < height)
              & (x0 + r >= 0) & (y0 + r >= 0))
    keep = visible[..., None, None, :] & on_map
    return torch.where(in_patch & keep, gauss,
                       torch.zeros((), dtype=dt, device=dev))


def decode_keypoints(heatmaps: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., H, W, K) heatmaps -> (kp_x, kp_y, confidence), each (..., K):
    the first maximal cell normalized to [0, 1] and its value."""
    h, w, k = heatmaps.shape[-3:]
    flat = heatmaps.reshape(*heatmaps.shape[:-3], h * w, k)
    # torch.max along a dim returns the first maximal index, as jnp.argmax
    conf, idx = flat.max(dim=-2)
    kp_y = torch.div(idx, w, rounding_mode="floor").float() / h
    kp_x = (idx % w).float() / w
    return kp_x, kp_y, conf
