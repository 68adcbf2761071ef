"""VGG-16 and VGG-19, configurations D and E (port of
deepvision_tpu/models/vgg.py).

Five stages of 3x3 SAME convs (64, 128, 256, 512, 512 channels; 2-2-3-3-3
or 2-2-4-4-4 convs) with ReLU, each closed by a 2x2/2 max pool, then
flatten -> Dense 4096 -> ReLU -> dropout -> Dense 4096 -> ReLU -> dropout
-> f32 head. The public input is NHWC; inside, NCHW. Convs and the hidden
dense layers run at the compute dtype (bf16) from f32 master weights, with
ReLU in that dtype; the head is f32. Dropout (0.5) follows each hidden
ReLU, its masks drawn from the step's generator.

Init as the JAX model's: `he_normal_fanout` conv kernels, normal(0.01)
dense kernels, zero biases. The leaves carry Flax's auto names (`Conv_<i>`,
`Dense_0..2`); the first dense layer takes the NHWC-flattened map, sized
from `image_size`.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import MODELS
from .common import (ComputeWeights, Conv, Dense, Dropout, _add_children,
                     flatten_nhwc, he_normal_fanout_, max_pool)

STAGES = (64, 128, 256, 512, 512)
DEPTHS = {"vgg16": (2, 2, 3, 3, 3), "vgg19": (2, 2, 4, 4, 4)}


class VGG(ComputeWeights, nn.Module):
    """`forward(x)` on (B, H, W, C) images -> (B, num_classes) f32."""

    def __init__(self, depths: Sequence[int], num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, *,
                 image_size: int = 224, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        side = image_size // 2 ** len(depths)
        if side < 1:
            raise ValueError(f"VGG needs at least {2 ** len(depths)} px: at "
                             f"{image_size} px its last pool has no output")
        self.dtype = dtype
        convs: List[Conv] = []
        self.pool_after = []
        c = channels
        for features, depth in zip(STAGES, depths):
            for _ in range(depth):
                convs.append(Conv(c, features, 3, use_bias=True,
                                  dtype=dtype))
                c = features
            self.pool_after.append(len(convs) - 1)
        self.convs = _add_children(self, convs)
        self.denses = _add_children(self, [
            Dense(side * side * c, 4096, dtype=dtype),
            Dense(4096, 4096, dtype=dtype),
            Dense(4096, num_classes, dtype=torch.float32)])
        self.dropout = Dropout(0.5)
        with torch.no_grad():
            for m in self.convs:
                he_normal_fanout_(m.weight, generator)
                m.bias.zero_()
            for m in self.denses:
                m.weight.normal_(0.0, 0.01, generator=generator)
                m.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            if i in self.pool_after:
                x = max_pool(x, 2, 2)
        x = flatten_nhwc(x)
        d1, d2, head = self.denses
        x = self.dropout(F.relu(d1(x)), generator)
        x = self.dropout(F.relu(d2(x)), generator)
        return head(x)


MODELS.register("vgg16", functools.partial(VGG, depths=DEPTHS["vgg16"]))
MODELS.register("vgg19", functools.partial(VGG, depths=DEPTHS["vgg19"]))
