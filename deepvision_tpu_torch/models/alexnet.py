"""AlexNet V1 and V2 (port of deepvision_tpu/models/alexnet.py).

V1 is the one-tower original (96/256/384/384/256 convs, LRN after the
first two, overlapping 3x3/2 max pools, two 4096 FC layers with dropout);
V2 the "one weird trick" widths 64/192/384/384/256 with the LRN kept.

The public input is NHWC, as in the JAX package; inside, NCHW. The dtype
policy is the JAX model's: convs and the hidden dense layers at the compute
dtype (bf16) from f32 master weights, ReLU applied in that dtype (there is
no BatchNorm), the LRN in f32 and cast back, and an f32 head. conv1 pads
(2, 2) explicitly, conv2-5 are SAME, the pools VALID. Dropout (0.5) sits
before each hidden dense layer, its masks drawn from the step's generator.

The leaves carry Flax's auto names (`Conv_0..4`, `Dense_0..2`), so
`utils/flax_convert.py` maps a Flax `params` tree onto this module leaf for
leaf; the first dense layer takes the NHWC-flattened map, whose size
follows from `image_size` (Flax infers it from the first input). Init is
Flax's default (lecun_normal kernels, zero biases), except V1's conv2-5,
whose biases start at 1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import MODELS
from .common import (ComputeWeights, Conv, Dense, Dropout, _add_children,
                     flatten_nhwc, lecun_normal_, lrn, max_pool, out_size)

CONV1_PAD = ((2, 2), (2, 2))


def _map_size(image_size: int) -> int:
    """Side of the map that the last pool leaves (conv1 11x11/4 pad 2, two
    SAME-conv stages and three VALID 3x3/2 pools)."""
    size = out_size(image_size, 11, 4, (2, 2))
    for _ in range(3):
        size = out_size(size, 3, 2)
    return size


class _AlexNet(ComputeWeights, nn.Module):
    """conv1 11x11/4 -> ReLU -> LRN -> pool, conv2 5x5 -> ReLU -> LRN ->
    pool, conv3-5 3x3 with ReLU -> pool, flatten, 2 x (dropout -> Dense
    4096 -> ReLU), f32 head. `forward(x)` on (B, H, W, C) images ->
    (B, num_classes) f32 logits."""

    def __init__(self, widths: Sequence[int], num_classes: int,
                 dtype: torch.dtype, bias_one: bool, *, image_size: int,
                 channels: int, generator: Optional[torch.Generator]):
        super().__init__()
        side = _map_size(image_size)
        if side < 1:
            smallest = next(s for s in range(image_size, 10**4)
                            if _map_size(s) >= 1)
            raise ValueError(f"AlexNet needs at least {smallest} px: at "
                             f"{image_size} px its last pool has no output")
        self.dtype = dtype
        w1, w2, w3, w4, w5 = widths
        convs = [Conv(channels, w1, 11, 4, use_bias=True, dtype=dtype,
                      padding=CONV1_PAD)]
        convs += [Conv(i, o, k, use_bias=True, dtype=dtype)
                  for i, o, k in ((w1, w2, 5), (w2, w3, 3), (w3, w4, 3),
                                  (w4, w5, 3))]
        self.convs = _add_children(self, convs)
        self.denses = _add_children(self, [
            Dense(side * side * w5, 4096, dtype=dtype),
            Dense(4096, 4096, dtype=dtype),
            Dense(4096, num_classes, dtype=torch.float32)])
        self.dropout = Dropout(0.5)
        with torch.no_grad():
            for i, m in enumerate(self.convs + self.denses):
                lecun_normal_(m.weight, generator)
                m.bias.fill_(1.0 if bias_one and 1 <= i <= 4 else 0.0)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        c1, c2, c3, c4, c5 = self.convs
        x = max_pool(lrn(F.relu(c1(x)), torch_size=c1.out_channels), 3, 2)
        x = max_pool(lrn(F.relu(c2(x)), torch_size=c2.out_channels), 3, 2)
        x = F.relu(c5(F.relu(c4(F.relu(c3(x))))))
        x = flatten_nhwc(max_pool(x, 3, 2))
        d1, d2, head = self.denses
        x = F.relu(d1(self.dropout(x, generator)))
        x = F.relu(d2(self.dropout(x, generator)))
        return head(x)


@MODELS.register("alexnet1")
class AlexNetV1(_AlexNet):
    """The original AlexNet (one tower); conv2-5 biases start at 1."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, *,
                 image_size: int = 227, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__((96, 256, 384, 384, 256), num_classes, dtype, True,
                         image_size=image_size, channels=channels,
                         generator=generator)


@MODELS.register("alexnet2")
class AlexNetV2(_AlexNet):
    """"One weird trick" widths, LRN kept after the first two blocks."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, *,
                 image_size: int = 224, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__((64, 192, 384, 384, 256), num_classes, dtype, False,
                         image_size=image_size, channels=channels,
                         generator=generator)
