"""ShuffleNet V1 (port of deepvision_tpu/models/shufflenet.py).

A 3x3/2 stem with BatchNorm and ReLU, a 3x3/2 max pool, three stages of
shuffle units (4, 8 and 4) and global average pool into an f32 head; the
channels per stage follow the group count g in {1, 2, 3, 4, 8} (the
paper's Table 1). A unit: grouped 1x1 (`gconv1`) -> BN -> ReLU -> channel
shuffle -> depthwise 3x3 (`dw`, the stride) -> BN -> grouped 1x1
(`gconv2`) -> BN, joined with the input: `relu(x + y)`, or at stride 2
`relu(concat(avg_pool(x), y))` with the 3x3/2 average-pooled input first.
The first unit's `gconv1` is a plain 1x1 and no shuffle follows it.

The public input is NHWC; inside, NCHW. Convs run at the compute dtype
(bf16) from f32 master weights, BatchNorm in f32, each BN's output (ReLU'd
in f32 where it has one) dropping to the compute dtype; the join and its
ReLU are in the compute dtype, as in the JAX model. Every conv, the max
pool and the shortcut's average pool are SAME (at stride 2 on an even size
XLA pads (0, 1)). The channel shuffle is a (g, c/g) transpose of the
channel axis: `view(n, g, c/g, h, w).transpose(1, 2)` on NCHW.

Leaves carry the JAX model's names: `stem`, `BatchNorm_0`,
`stage<s>_unit<u>` with `gconv1`, `dw`, `gconv2` and `BatchNorm_0..2`, and
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
                     avg_pool, global_avg_pool, he_normal_fanout_,
                     lecun_normal_, max_pool)

BN_EPS = 1e-5
# output channels per stage for each group count: the paper's Table 1
STAGE_CHANNELS = {1: (144, 288, 576), 2: (200, 400, 800),
                  3: (240, 480, 960), 4: (272, 544, 1088),
                  8: (384, 768, 1536)}
STAGE_REPEATS = (4, 8, 4)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Transpose the (groups, c / groups) view of NCHW `x`'s channels."""
    n, c, h, w = x.shape
    return x.view(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


class ShuffleUnit(nn.Module):
    def __init__(self, in_features: int, features: int, groups: int = 3,
                 stride: int = 1, first_unit_no_gconv: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.groups = groups
        self.stride = stride
        bottleneck = features // 4
        out = features - in_features if stride == 2 else features
        self.g1 = 1 if first_unit_no_gconv else groups
        self.gconv1 = Conv(in_features, bottleneck, 1, dtype=dtype,
                           groups=self.g1)
        self.dw = Conv(bottleneck, bottleneck, 3, stride, dtype=dtype,
                       groups=bottleneck)
        self.gconv2 = Conv(bottleneck, out, 1, dtype=dtype, groups=groups)
        self.bns = _add_children(self, [BatchNorm(bottleneck, eps=BN_EPS),
                                        BatchNorm(bottleneck, eps=BN_EPS),
                                        BatchNorm(out, eps=BN_EPS)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bns[0](self.gconv1(x))).to(self.dtype)
        if self.g1 > 1:
            y = channel_shuffle(y, self.groups)
        y = self.bns[1](self.dw(y)).to(self.dtype)
        y = self.bns[2](self.gconv2(y)).to(self.dtype)
        if self.stride == 2:
            shortcut = avg_pool(x, 3, 2, "SAME")
            return F.relu(torch.cat([shortcut, y], dim=1)).to(self.dtype)
        return F.relu(x + y).to(self.dtype)


@MODELS.register("shufflenet_v1")
class ShuffleNetV1(ComputeWeights, nn.Module):
    """`forward(x)` on (B, H, W, C) images -> (B, num_classes) f32."""

    def __init__(self, num_classes: int = 1000, groups: int = 3,
                 dtype: torch.dtype = torch.bfloat16, *, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if groups not in STAGE_CHANNELS:
            raise ValueError(f"ShuffleNet V1 takes groups in "
                             f"{sorted(STAGE_CHANNELS)}, got {groups}")
        self.dtype = dtype
        self.stem = Conv(channels, 24, 3, 2, dtype=dtype)
        self.bns = _add_children(self, [BatchNorm(24, eps=BN_EPS)])
        self.units = []
        c = 24
        for stage, (features, reps) in enumerate(
                zip(STAGE_CHANNELS[groups], STAGE_REPEATS)):
            for unit in range(reps):
                m = ShuffleUnit(c, features, groups=groups,
                                stride=2 if unit == 0 else 1,
                                first_unit_no_gconv=stage == 0 and unit == 0,
                                dtype=dtype)
                self.add_module(f"stage{stage + 2}_unit{unit}", m)
                self.units.append(m)
                c = features
        self.head = Dense(c, num_classes)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv):
                    he_normal_fanout_(m.weight, generator)
            lecun_normal_(self.head.weight, generator)
            self.head.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.stem(x.to(self.dtype).permute(0, 3, 1, 2))
        x = F.relu(self.bns[0](x)).to(self.dtype)
        x = max_pool(x, 3, 2, "SAME")
        for unit in self.units:
            x = unit(x)
        return self.head(global_avg_pool(x, self.dtype))
