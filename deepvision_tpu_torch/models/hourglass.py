"""Stacked Hourglass network (Newell et al. 2016), port of
deepvision_tpu/models/hourglass.py.

Pre-activation bottlenecks (BN -> ReLU -> 1x1 / 3x3 / 1x1, half-width
middle, a biased 1x1 `proj` lift when the width changes), recursive
order-N hourglass modules (2x2/2 max pool down, nearest x2 up), a
7x7/2 stem -> BN-ReLU -> bottleneck -> 2x2/2 max pool -> bottlenecks,
then `num_stack` stacks, each emitting a (B, H/4, W/4, num_heatmap)
prediction and, but the last, re-injecting it through two 1x1 convs.

The public input is NHWC, as in the JAX package; inside, NCHW. Numerics
follow Flax (models/common.py): every conv has a bias and runs at the
compute dtype from f32 master weights with SAME padding; BatchNorm
(momentum 0.9, eps 1e-3) normalizes in f32, then ReLU in f32 and a cast
to the compute dtype; the max pools are VALID (an odd map loses its last
row and column); the heads `head_<i>` are f32 convs on the bf16
activations, which they promote to f32 as Flax does. Init:
`he_normal_fanout` kernels, zero biases.

Children carry Flax's names (`stem_conv`, `proj`, `head_<i>`, and the
auto names `PreActBottleneck_<i>`, `HourglassModule_<i>`, `Conv_<i>`,
`BatchNorm_<i>` through `flax_auto_names`), so `utils/flax_convert.py`
maps a Flax `params` + `batch_stats` pair onto this module leaf for leaf.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import MODELS
from .common import (BatchNorm, ComputeWeights, Conv, _add_children,
                     he_normal_fanout_, max_pool)
from .yolo import upsample2x

BN_MOMENTUM, BN_EPS = 0.9, 1e-3


def _bn_relu(bn: nn.Module, x: torch.Tensor, dtype: torch.dtype
             ) -> torch.Tensor:
    """relu(bn(x)) in f32, then the compute dtype."""
    return F.relu(bn(x)).to(dtype)


class PreActBottleneck(nn.Module):
    """BN -> ReLU -> conv, three times (1x1, 3x3, 1x1 at half width in the
    middle), plus the identity or, when the width changes, its 1x1 `proj`
    lift of the block's raw input."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        half = features // 2
        self.proj = (Conv(in_features, features, 1, use_bias=True,
                          dtype=dtype)
                     if in_features != features else None)
        self.bns = _add_children(self, [
            BatchNorm(c, eps=BN_EPS, momentum=BN_MOMENTUM)
            for c in (in_features, half, half)])
        self.convs = _add_children(self, [
            Conv(in_features, half, 1, use_bias=True, dtype=dtype),
            Conv(half, half, 3, use_bias=True, dtype=dtype),
            Conv(half, features, 1, use_bias=True, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.proj is None else self.proj(x)
        y = x
        for bn, conv in zip(self.bns, self.convs):
            y = conv(_bn_relu(bn, y, self.dtype))
        return identity + y


class HourglassModule(nn.Module):
    """Recursive order-N hourglass: a residual upper branch; max pool ->
    residuals -> the order N-1 module (residuals at order 1) -> residuals
    -> nearest x2, added to the upper branch."""

    def __init__(self, order: int, features: int, num_residual: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()

        def blocks(n: int) -> List[nn.Module]:
            return [PreActBottleneck(features, features, dtype)
                    for _ in range(n)]

        self.up = blocks(1 + num_residual)
        self.down = blocks(num_residual)
        self.inner = ([HourglassModule(order - 1, features, num_residual,
                                       dtype)]
                      if order > 1 else blocks(num_residual))
        self.out = blocks(num_residual)
        _add_children(self, self.up + self.down + self.inner + self.out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = x
        for blk in self.up:
            up1 = blk(up1)
        low = max_pool(x, 2, 2)
        for blk in self.down + self.inner + self.out:
            low = blk(low)
        return up1 + upsample2x(low)


class StackedHourglass(ComputeWeights, nn.Module):
    """Stem -> `num_stack` hourglasses with intermediate supervision.
    `forward(x)` on (B, H, W, C) images -> a tuple of `num_stack` raw
    (B, H/4, W/4, num_heatmap) f32 heatmaps."""

    def __init__(self, num_heatmap: int = 16, num_stack: int = 4,
                 num_residual: int = 1, order: int = 4,
                 width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, *, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.num_stack = num_stack
        w = lambda f: max(2, int(f * width_mult))  # noqa: E731
        f = w(256)
        self.stem_conv = Conv(channels, w(64), 7, 2, use_bias=True,
                              dtype=dtype)
        self.stem = [PreActBottleneck(w(64), w(128), dtype),
                     PreActBottleneck(w(128), w(128), dtype),
                     PreActBottleneck(w(128), f, dtype)]
        bns = [BatchNorm(w(64), eps=BN_EPS, momentum=BN_MOMENTUM)]
        self.hourglasses: List[nn.Module] = []
        self.residuals: List[List[nn.Module]] = []
        self.linears: List[nn.Module] = []
        self.reinject: List[Tuple[nn.Module, nn.Module]] = []
        convs: List[nn.Module] = []
        blocks = list(self.stem)
        for stack in range(num_stack):
            self.hourglasses.append(HourglassModule(order, f, num_residual,
                                                    dtype))
            res = [PreActBottleneck(f, f, dtype) for _ in range(num_residual)]
            self.residuals.append(res)
            blocks += res
            linear = Conv(f, f, 1, use_bias=True, dtype=dtype)
            self.linears.append(linear)
            convs.append(linear)
            bns.append(BatchNorm(f, eps=BN_EPS, momentum=BN_MOMENTUM))
            self.add_module(f"head_{stack}", Conv(
                f, num_heatmap, 1, use_bias=True, dtype=torch.float32))
            if stack < num_stack - 1:
                pair = (Conv(f, f, 1, use_bias=True, dtype=dtype),
                        Conv(num_heatmap, f, 1, use_bias=True, dtype=dtype))
                self.reinject.append(pair)
                convs += pair
        self.bns = _add_children(self, bns)
        _add_children(self, blocks + self.hourglasses + convs)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv):
                    he_normal_fanout_(m.weight, generator)
                    m.bias.zero_()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.stem_conv(x.permute(0, 3, 1, 2))
        x = _bn_relu(self.bns[0], x, self.dtype)
        x = self.stem[0](x)
        x = max_pool(x, 2, 2)
        x = self.stem[2](self.stem[1](x))
        ys = []
        for stack in range(self.num_stack):
            x = self.hourglasses[stack](x)
            for blk in self.residuals[stack]:
                x = blk(x)
            x = _bn_relu(self.bns[1 + stack], self.linears[stack](x),
                         self.dtype)
            y = getattr(self, f"head_{stack}")(x)
            ys.append(y.permute(0, 2, 3, 1))
            if stack < self.num_stack - 1:
                from_x, from_y = self.reinject[stack]
                x = from_x(x) + from_y(y.to(self.dtype))
        return tuple(ys)


MODELS.register("hourglass104", StackedHourglass)
