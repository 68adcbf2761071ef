"""LeNet-5 (port of deepvision_tpu/models/lenet.py).

C1/S2/C3/S4/C5/F6 with tanh after each conv and after each 2x2 average
pool, VALID convs, f32 throughout, on a 32x32x1 input (MNIST padded
28 -> 32). The public input is NHWC, as in the JAX package. The leaves are
Flax's: `c1`, `c3`, `c5` (convs with bias), `f6` and `output` (dense), with
Flax's default init (lecun_normal kernels, zero biases).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import MODELS
from .common import ComputeWeights, Conv, lecun_normal_


@MODELS.register("lenet5")
class LeNet5(ComputeWeights, nn.Module):
    """`forward(x)` on (B, 32, 32, C) images -> (B, num_classes) f32."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, *, channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        conv = lambda i, o: Conv(i, o, 5, use_bias=True, dtype=dtype,  # noqa: E731
                                 padding="VALID")
        self.c1 = conv(channels, 6)
        self.c3 = conv(6, 16)
        self.c5 = conv(16, 120)
        self.f6 = nn.Linear(120, 84)
        self.output = nn.Linear(84, num_classes)
        with torch.no_grad():
            for m in (self.c1, self.c3, self.c5, self.f6, self.output):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()

    def penultimate(self, x: torch.Tensor) -> torch.Tensor:
        """F6's output before its tanh: the 84-dim embedding the GAN
        evaluation reads (core/eval_gan.py)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = torch.tanh(F.avg_pool2d(torch.tanh(self.c1(x)), 2))
        x = torch.tanh(F.avg_pool2d(torch.tanh(self.c3(x)), 2))
        x = torch.tanh(self.c5(x))
        # Flax flattens NHWC; over a 1x1 map that is NCHW's order too
        if x.shape[-2:] != (1, 1):
            raise ValueError(f"LeNet-5 takes 32x32 inputs: C5 gave a "
                             f"{tuple(x.shape[-2:])} map, whose NCHW flatten "
                             f"order is not Flax's NHWC one")
        return F.linear(x.flatten(1), self.f6.weight.to(self.dtype),
                        self.f6.bias.to(self.dtype))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.tanh(self.penultimate(x))
        return F.linear(x, self.output.weight.to(self.dtype),
                        self.output.bias.to(self.dtype)).float()
