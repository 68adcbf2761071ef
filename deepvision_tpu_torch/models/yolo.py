"""YOLO V3 — Darknet-53 backbone and a 3-scale FPN detection head (port of
deepvision_tpu/models/yolo.py).

Conv-BN-LeakyReLU(0.1) blocks, residual stages (1, 2, 8, 8, 4), detection
towers of alternating 1x1/3x3 convs, nearest x2 upsample and concat for the
medium and small scales, and a final 1x1 conv to 3 * (5 + C) channels
reshaped to (B, g, g, 3, 5 + C). The public input is NHWC, as in the JAX
package. Train mode returns the 3 raw heads, finest grid (stride 8) first;
eval mode decodes them (`decode=False` keeps them raw).

Numerics follow Flax (models/common.py's `Conv` and `BatchNorm`): convs
at the compute dtype from f32 master weights with SAME padding; BatchNorm
with eps 1e-3 in f32, then leaky_relu(0.1) and a cast to the compute dtype.
The final conv has a bias and runs in f32.

Children carry Flax's names (`darknet53`, `tower_*`, `lateral_*`,
`final_conv`, and the auto names `ConvBNLeaky_<i>`, `DarknetResidual_<i>`,
`Conv_0`, `BatchNorm_0` through `flax_auto_names`), so
`utils/flax_convert.py` maps a Flax `params` + `batch_stats` pair onto this
module leaf for leaf.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.yolo import ANCHORS_WH, decode_boxes
from ..utils.registry import MODELS
from .common import (BatchNorm, ComputeWeights, Conv, _add_children,
                     lecun_normal_)

BN_EPS = 1e-3        # the reference's Keras BatchNormalization default


class ConvBNLeaky(nn.Module):
    """Same-padded conv without bias, BatchNorm, LeakyReLU 0.1."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 strides: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.layers = _add_children(self, [
            Conv(in_features, features, kernel, strides, dtype=dtype),
            BatchNorm(features, eps=BN_EPS)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.layers
        return F.leaky_relu(bn(conv(x)), 0.1).to(self.dtype)


class DarknetResidual(nn.Module):
    """1x1 squeeze → 3x3 expand, plus the shortcut."""

    def __init__(self, in_features: int, features1: int, features2: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.layers = _add_children(self, [
            ConvBNLeaky(in_features, features1, 1, dtype=dtype),
            ConvBNLeaky(features1, features2, 3, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze, expand = self.layers
        return x + expand(squeeze(x))


def _width(features: int, width_mult: float) -> int:
    return max(1, int(features * width_mult))


class Darknet53(nn.Module):
    """Darknet-53 backbone → features at strides 8, 16 and 32."""

    def __init__(self, stage_blocks: Sequence[int] = (1, 2, 8, 8, 4),
                 width_mult: float = 1.0, dtype: torch.dtype = torch.bfloat16,
                 channels: int = 3):
        super().__init__()
        w = lambda f: _width(f, width_mult)  # noqa: E731
        layers: List[nn.Module] = [ConvBNLeaky(channels, w(32), 3, dtype=dtype)]
        taps = []
        c = w(32)
        for stage, (blocks, f) in enumerate(
                zip(stage_blocks, (64, 128, 256, 512, 1024))):
            layers.append(ConvBNLeaky(c, w(f), 3, strides=2, dtype=dtype))
            c = w(f)
            layers += [DarknetResidual(c, w(f // 2), c, dtype=dtype)
                       for _ in range(blocks)]
            if stage >= 2:
                taps.append(len(layers) - 1)
        self.layers = _add_children(self, layers)
        self.taps = frozenset(taps)
        self.out_features = (w(256), w(512), w(1024))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i in self.taps:
                outs.append(x)
        return tuple(outs)


class _DetectionTower(nn.Module):
    """5-conv tower and the 3x3/1x1 prediction head of one scale. Returns
    (x, y): x feeds the next, finer scale; y is the raw prediction (f32)."""

    def __init__(self, in_features: int, features: int, final_filters: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        f = features
        specs = [(in_features, f, 1), (f, 2 * f, 3), (2 * f, f, 1),
                 (f, 2 * f, 3), (2 * f, f, 1), (f, 2 * f, 3)]
        self.convs = _add_children(self, [ConvBNLeaky(i, o, k, dtype=dtype)
                                          for i, o, k in specs])
        self.final_conv = Conv(2 * f, final_filters, 1, use_bias=True,
                               dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for conv in self.convs[:5]:
            x = conv(x)
        return x, self.final_conv(self.convs[5](x))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 on NCHW: each pixel repeated 2x2, as
    `jax.image.resize(..., "nearest")` does for an exact doubling."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


@MODELS.register("yolov3")
class YoloV3(ComputeWeights, nn.Module):
    """Full detector. `forward(x)` on (B, H, W, C) images: in train mode
    the 3 raw heads (B, g, g, 3, 5 + C) f32 at strides (8, 16, 32); in eval
    mode the 3 decoded (boxes_xywh, objectness, class_probs) triples, or the
    raw heads with `decode=False`."""

    def __init__(self, num_classes: int = 80, width_mult: float = 1.0,
                 stage_blocks: Sequence[int] = (1, 2, 8, 8, 4),
                 dtype: torch.dtype = torch.bfloat16, *, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        w = lambda f: _width(f, width_mult)  # noqa: E731
        final_filters = 3 * (5 + num_classes)
        self.darknet53 = Darknet53(stage_blocks, width_mult, dtype, channels)
        c_small, c_medium, c_large = self.darknet53.out_features
        self.tower_large = _DetectionTower(c_large, w(512), final_filters,
                                           dtype)
        self.lateral_medium = ConvBNLeaky(w(512), w(256), 1, dtype=dtype)
        self.tower_medium = _DetectionTower(w(256) + c_medium, w(256),
                                            final_filters, dtype)
        self.lateral_small = ConvBNLeaky(w(256), w(128), 1, dtype=dtype)
        self.tower_small = _DetectionTower(w(128) + c_small, w(128),
                                           final_filters, dtype)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's initializers, drawn from `generator`: lecun_normal
        (truncated at 2 std) conv kernels, zero biases, unit BatchNorm
        scales, running mean 0 and variance 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor, decode: Optional[bool] = None):
        if decode is None:
            decode = not self.training
        x = x.permute(0, 3, 1, 2)
        x_small, x_medium, x_large = self.darknet53(x)
        xl, y_large = self.tower_large(x_large)
        xm = torch.cat([upsample2x(self.lateral_medium(xl)), x_medium], dim=1)
        xm, y_medium = self.tower_medium(xm)
        xs = torch.cat([upsample2x(self.lateral_small(xm)), x_small], dim=1)
        _, y_small = self.tower_small(xs)

        def heads(y):  # (B, 3(5+C), g, g) → (B, g, g, 3, 5 + C)
            b, _, g1, g2 = y.shape
            return y.permute(0, 2, 3, 1).reshape(b, g1, g2, 3,
                                                 5 + self.num_classes)

        raw = tuple(heads(y) for y in (y_small, y_medium, y_large))
        if not decode:
            return raw
        return tuple(decode_boxes(y, ANCHORS_WH[3 * i:3 * i + 3],
                                  self.num_classes)
                     for i, y in enumerate(raw))
