"""MobileNet V1 (port of deepvision_tpu/models/mobilenet.py).

A 3x3/2 stem and 13 depthwise-separable blocks (a depthwise 3x3 conv,
`groups` = its channels, then a pointwise 1x1, each followed by
BatchNorm and ReLU), global average pool, f32 head. The width multiplier
`alpha` gives each layer max(8, int(channels * alpha)) channels.

The public input is NHWC; inside, NCHW. Convs run at the compute dtype
(bf16) from f32 master weights; each BatchNorm normalizes in f32 (Flax
momentum 0.9, epsilon 1e-5), ReLU is applied in f32 and the result drops to
the compute dtype; the global pool is an f32 mean returned in the compute
dtype; the head is f32. The stem and the depthwise convs pad (1, 1)
explicitly, as the JAX model does (SAME would pad (0, 1) at stride 2 on an
even size).

Leaves carry the JAX model's names: `stem`, `BatchNorm_0`, `blocks.<i>`
(Flax's `block<i>`) with `dw`, `BatchNorm_0`, `pw`, `BatchNorm_1`, and
`head`. Init: `he_normal_fanout` conv kernels without biases, unit
BatchNorm scales, a lecun_normal head with a zero bias.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import MODELS
from .common import (BatchNorm, ComputeWeights, Conv, Dense, _add_children,
                     global_avg_pool, he_normal_fanout_, lecun_normal_)

BN_EPS = 1e-5
PAD1 = ((1, 1), (1, 1))
# (features, stride) after the stem: the paper's Table 1
BODY = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
        (1024, 1))


def _bn_relu(bn: BatchNorm, x: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """BatchNorm in f32, ReLU in f32, then the compute dtype."""
    return F.relu(bn(x)).to(dtype)


class DepthwiseSeparable(nn.Module):
    """dw 3x3 (pad 1) -> BN -> ReLU -> pw 1x1 -> BN -> ReLU."""

    def __init__(self, in_features: int, features: int, strides: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.dw = Conv(in_features, in_features, 3, strides, dtype=dtype,
                       padding=PAD1, groups=in_features)
        self.pw = Conv(in_features, features, 1, dtype=dtype)
        self.bns = _add_children(self, [BatchNorm(in_features, eps=BN_EPS),
                                        BatchNorm(features, eps=BN_EPS)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _bn_relu(self.bns[0], self.dw(x), self.dtype)
        return _bn_relu(self.bns[1], self.pw(x), self.dtype)


@MODELS.register("mobilenet_v1")
class MobileNetV1(ComputeWeights, nn.Module):
    """`forward(x)` on (B, H, W, C) images -> (B, num_classes) f32."""

    def __init__(self, num_classes: int = 1000, alpha: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, *, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype

        def c(ch: int) -> int:
            return max(8, int(ch * alpha))

        self.stem = Conv(channels, c(32), 3, 2, dtype=dtype, padding=PAD1)
        self.bns = _add_children(self, [BatchNorm(c(32), eps=BN_EPS)])
        blocks = []
        cin = c(32)
        for features, stride in BODY:
            blocks.append(DepthwiseSeparable(cin, c(features), stride,
                                             dtype))
            cin = c(features)
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(cin, num_classes)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv):
                    he_normal_fanout_(m.weight, generator)
            lecun_normal_(self.head.weight, generator)
            self.head.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.stem(x.to(self.dtype).permute(0, 3, 1, 2))
        x = _bn_relu(self.bns[0], x, self.dtype)
        for block in self.blocks:
            x = block(x)
        return self.head(global_avg_pool(x, self.dtype))
