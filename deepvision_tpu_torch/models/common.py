"""Shared building blocks of the port's model zoo (own copy of
deepvision_tpu/models/common.py: `he_normal_fanout`, `ConvBN`; and the
Flax-numerics `Conv` and `BatchNorm` every BN-conv model uses).

Numerics follow Flax where they differ from torch's defaults:
- `Conv` computes at the compute dtype from f32 master weights, cast per
  call as Flax's `dtype=` policy does (no autocast). Its padding is Flax's:
  "SAME" (XLA's: a stride-2 3x3 conv on an even input pads 0 before and 1
  after, which `nn.Conv2d(padding=1)` does not), "VALID", or explicit
  `[(lo, hi), (lo, hi)]`;
- `BatchNorm` normalizes in f32 whatever its input, with the batch
  statistics in training and the running ones in eval, and returns its
  `dtype`. Its momentum is Flax's (0.9 keeps 90% of the running value;
  torch's convention is the complement), and the running variance takes
  the BIASED batch variance, as Flax's does (torch feeds the unbiased one).

Children that Flax names itself (`Conv_0`, `BatchNorm_0`, ...) carry the
same names here through `flax_auto_names`, so `utils/flax_convert.py` maps
a Flax `params` + `batch_stats` pair onto a port module leaf for leaf.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.flax_convert import flax_auto_names

Padding = Union[str, Sequence[Tuple[int, int]]]

# flax variance_scaling("truncated_normal") divides the standard deviation
# by that of a unit normal truncated to [-2, 2]
TRUNCATED_NORMAL_STD = 0.87962566103423978


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _add_children(parent: nn.Module, children: Sequence[nn.Module]
                  ) -> List[nn.Module]:
    """Register `children` under Flax's auto names; return them as a plain
    list (kept on a plain attribute, so nothing registers twice)."""
    for name, child in flax_auto_names(children):
        parent.add_module(name, child)
    return list(children)


def truncated_normal_(weight: torch.Tensor, std: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's truncated normal: N(0, std) cut at +-2 std."""
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's default kernel init, variance_scaling(1, "fan_in",
    "truncated_normal"), on a torch (out, in, ...) weight."""
    fan_in = weight[0].numel()
    return truncated_normal_(weight, (1.0 / fan_in) ** 0.5
                             / TRUNCATED_NORMAL_STD, generator)


def he_normal_fanout_(weight: torch.Tensor,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """`he_normal_fanout` = variance_scaling(2.0, "fan_out",
    "truncated_normal") on a torch OIHW weight: fan-out = kh * kw * out."""
    fan_out = weight.shape[0] * weight[0, 0].numel()
    return truncated_normal_(weight, (2.0 / fan_out) ** 0.5
                             / TRUNCATED_NORMAL_STD, generator)


class Conv(nn.Conv2d):
    """Flax `nn.Conv` at the compute dtype `dtype`, padding "SAME" (the
    default), "VALID" or `[(lo, hi), (lo, hi)]`."""

    def __init__(self, in_features: int, features: int,
                 kernel: Union[int, Tuple[int, int]], strides: int = 1,
                 use_bias: bool = False, dtype: torch.dtype = torch.float32,
                 padding: Padding = "SAME"):
        super().__init__(in_features, features, kernel, stride=strides,
                         padding=0, bias=use_bias)
        if isinstance(padding, str) and padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME', 'VALID' or "
                             f"[(lo, hi), (lo, hi)], got {padding!r}")
        self.dtype = dtype
        self.flax_padding = (padding if isinstance(padding, str)
                             else tuple(tuple(p) for p in padding))

    def _pads(self, x: torch.Tensor) -> Tuple[Tuple[int, int], ...]:
        if self.flax_padding == "VALID":
            return (0, 0), (0, 0)
        if self.flax_padding == "SAME":
            return tuple(_same_pads(x.shape[d], self.kernel_size[i],
                                    self.stride[i])
                         for i, d in enumerate((-2, -1)))
        return self.flax_padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = self._pads(x)
        x = x.to(self.dtype)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride)


class BatchNorm(nn.BatchNorm2d):
    """Flax `nn.BatchNorm(momentum, epsilon)` on NCHW: f32 normalization,
    output in `dtype` (f32 unless a model asks for its compute dtype)."""

    def __init__(self, features: int, *, eps: float, momentum: float = 0.9,
                 dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps, momentum=1.0 - momentum)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.dtype)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        # the running statistics take the biased batch variance, as Flax's
        # do (torch's own update would fold in var * n / (n - 1))
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y.to(self.dtype)


class ConvBN(nn.Module):
    """Conv → BatchNorm → (optional) ReLU, returned in the compute dtype
    (`deepvision_tpu/models/common.py::ConvBN`): the conv has no bias
    unless `use_bias` or `use_bn=False`, its kernel `he_normal_fanout`;
    the BatchNorm runs in f32 with Flax momentum 0.9, epsilon 1e-5."""

    def __init__(self, in_features: int, features: int,
                 kernel: Union[int, Tuple[int, int]] = 3, strides: int = 1,
                 padding: Padding = "SAME", use_bias: bool = False,
                 relu: bool = True, use_bn: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.relu = relu
        self.dtype = dtype
        conv = Conv(in_features, features, kernel, strides,
                    use_bias=use_bias or not use_bn, dtype=dtype,
                    padding=padding)
        bn = ([BatchNorm(features, eps=bn_epsilon, momentum=bn_momentum)]
              if use_bn else [])
        self.layers = _add_children(self, [conv] + bn)
        with torch.no_grad():
            he_normal_fanout_(conv.weight, generator)
            if conv.bias is not None:
                conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        if self.relu:
            x = F.relu(x)
        return x.to(self.dtype)
