"""CenterNet / ObjectsAsPoints — the 2-stack order-5 hourglass detector,
port of deepvision_tpu/models/centernet.py.

Post-activation residual blocks (conv1x1-BN-ReLU -> conv3x3-BN, a BN'd
1x1 shortcut on a width or stride change, ReLU after the add), recursive
order-N modules with a stride-2 lower branch (no max pool) and the
per-order filter and residual tables, a 7x7/2 stem and a stride-2
residual block (output stride 4), and per stack a 3x3 `post_hg_<i>` conv
and a detection head `head_<i>` of three towers (heatmap, size, offset):
a 3x3 conv at the compute dtype, ReLU, then an f32 3x3 conv. Between
stacks the head's input and the stack's input are re-injected through
BN'd 1x1 convs and a residual block.

The public input is NHWC, as in the JAX package; inside, NCHW. Numerics
follow Flax (models/common.py): convs at the compute dtype from f32
master weights with SAME padding (a stride-2 one pads asymmetrically);
only `post_hg_<i>`, the re-injection 1x1s and the head convs have a bias;
BatchNorm (momentum 0.99, eps 1e-3) normalizes in f32 and is cast to the
compute dtype, before the ReLU where one follows; the residual add and
its ReLU are in the compute dtype; the heads' second convs run in f32 on
the bf16 activations. Init: Flax's default `lecun_normal` kernels, zero
biases but the heatmap's second conv, -2.19 (an initial sigmoid of 0.1).

Children carry Flax's names (`post_hg_<i>`, `head_<i>`, `<tower>_conv1`,
`<tower>_conv2`, and the auto names `ResidualBlock_<i>`,
`CenterNetHourglass_<i>`, `Conv_<i>`, `BatchNorm_<i>`), so
`utils/flax_convert.py` maps a Flax `params` + `batch_stats` pair onto
this module leaf for leaf.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import MODELS
from .common import (BatchNorm, ComputeWeights, Conv, _add_children,
                     lecun_normal_)
from .yolo import upsample2x

# `ObjectsAsPoints/tensorflow/model.py:17-32`
ORDER_TO_FILTERS = {5: (256, 256), 4: (256, 384), 3: (384, 384),
                    2: (384, 384), 1: (384, 512)}
ORDER_TO_NUM_RESIDUAL = {5: (2, 2), 4: (2, 2), 3: (2, 2), 2: (2, 2),
                         1: (2, 4)}
BN_MOMENTUM, BN_EPS = 0.99, 1e-3
HEATMAP_BIAS = -2.19


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def _width(width_mult: float):
    return lambda f: max(2, int(f * width_mult))


class ResidualBlock(nn.Module):
    """conv1x1(stride)-BN-ReLU -> conv3x3-BN, plus the identity or its
    BN'd 1x1 (stride) projection; ReLU after the add."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.project = in_features != features or strides > 1
        convs: List[nn.Module] = []
        bns: List[nn.Module] = []
        if self.project:
            convs.append(Conv(in_features, features, 1, strides,
                              dtype=dtype))
            bns.append(_bn(features))
        convs += [Conv(in_features, features, 1, strides, dtype=dtype),
                  Conv(features, features, 3, dtype=dtype)]
        bns += [_bn(features), _bn(features)]
        self.convs = _add_children(self, convs)
        self.bns = _add_children(self, bns)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        identity = x
        if self.project:
            identity = self.bns[0](self.convs[0](x)).to(dt)
        conv1, conv2 = self.convs[-2:]
        bn1, bn2 = self.bns[-2:]
        y = F.relu(bn1(conv1(x))).to(dt)
        y = bn2(conv2(y)).to(dt)
        return F.relu(identity + y)


class CenterNetHourglass(nn.Module):
    """Recursive order-N module with a stride-2 lower branch: the upper
    branch's residuals; a stride-2 residual, its residuals, the order N-1
    module (residuals at order 1), residuals back to the current width;
    nearest x2, added to the upper branch."""

    def __init__(self, in_features: int, order: int, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        w = _width(width_mult)
        curr_f, next_f = (w(f) for f in ORDER_TO_FILTERS[order])
        curr_r, next_r = ORDER_TO_NUM_RESIDUAL[order]
        self.out_features = curr_f
        self.up: List[nn.Module] = []
        c = in_features
        for _ in range(curr_r):
            self.up.append(ResidualBlock(c, curr_f, dtype=dtype))
            c = curr_f
        self.low: List[nn.Module] = [
            ResidualBlock(in_features, next_f, strides=2, dtype=dtype)]
        self.low += [ResidualBlock(next_f, next_f, dtype=dtype)
                     for _ in range(curr_r - 1)]
        if order > 1:
            inner = CenterNetHourglass(next_f, order - 1, width_mult, dtype)
            self.low.append(inner)
            c = inner.out_features
        else:
            self.low += [ResidualBlock(next_f, next_f, dtype=dtype)
                         for _ in range(next_r)]
            c = next_f
        for _ in range(curr_r - 1):
            self.low.append(ResidualBlock(c, next_f, dtype=dtype))
            c = next_f
        self.low.append(ResidualBlock(c, curr_f, dtype=dtype))
        _add_children(self, self.up + self.low)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = x
        for blk in self.up:
            up1 = blk(up1)
        low = x
        for blk in self.low:
            low = blk(low)
        return up1 + upsample2x(low)


class DetectionHead(nn.Module):
    """Per output a tower: 3x3 conv at the compute dtype, ReLU, then a 3x3
    f32 conv: {"heatmap": (B, C, g, g), "size": (B, 2, g, g), "offset":
    (B, 2, g, g)} (NCHW; the model returns NHWC)."""

    TOWERS = ("heatmap", "size", "offset")

    def __init__(self, in_features: int, num_classes: int,
                 width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        w = max(2, int(256 * width_mult))
        for name, filters in zip(self.TOWERS, (num_classes, 2, 2)):
            self.add_module(f"{name}_conv1", Conv(in_features, w, 3,
                                                  use_bias=True, dtype=dtype))
            self.add_module(f"{name}_conv2", Conv(w, filters, 3,
                                                  use_bias=True,
                                                  dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, f"{name}_conv2")(
                    F.relu(getattr(self, f"{name}_conv1")(x)))
                for name in self.TOWERS}


class ObjectsAsPoints(ComputeWeights, nn.Module):
    """The full detector. `forward(x)` on (B, H, W, C) images -> a tuple of
    `num_stack` dicts {"heatmap" (B, H/4, W/4, C) logits, "size"
    (B, H/4, W/4, 2), "offset" (B, H/4, W/4, 2)}, all f32."""

    def __init__(self, num_classes: int = 80, num_stack: int = 2,
                 order: int = 5, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, *, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.num_stack = num_stack
        w = _width(width_mult)
        convs: List[nn.Module] = [Conv(channels, w(128), 7, 2, dtype=dtype)]
        bns: List[nn.Module] = [_bn(w(128))]
        blocks: List[nn.Module] = [ResidualBlock(w(128), w(256), strides=2,
                                                 dtype=dtype)]
        self.hourglasses: List[nn.Module] = []
        self.post_bns: List[nn.Module] = []
        self.reinject: List[tuple] = []
        for stack in range(num_stack):
            hg = CenterNetHourglass(w(256), order, width_mult, dtype)
            self.hourglasses.append(hg)
            self.add_module(f"post_hg_{stack}", Conv(
                hg.out_features, w(256), 3, use_bias=True, dtype=dtype))
            self.post_bns.append(_bn(w(256)))
            bns.append(self.post_bns[-1])
            self.add_module(f"head_{stack}", DetectionHead(
                w(256), num_classes, width_mult, dtype))
            if stack < num_stack - 1:
                pair = [Conv(w(256), w(256), 1, use_bias=True, dtype=dtype)
                        for _ in range(2)]
                pair_bns = [_bn(w(256)) for _ in range(2)]
                block = ResidualBlock(w(256), w(256), dtype=dtype)
                self.reinject.append((*pair, *pair_bns, block))
                convs += pair
                bns += pair_bns
                blocks.append(block)
        self.convs = _add_children(self, convs)
        self.bns = _add_children(self, bns)
        self.blocks = _add_children(self, blocks)
        _add_children(self, self.hourglasses)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's initializers, drawn from `generator`: lecun_normal
        kernels, zero biases (the heatmap's last conv -2.19), unit
        BatchNorm scales, running mean 0 and variance 1."""
        for name, m in self.named_modules():
            if isinstance(m, Conv):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.fill_(HEATMAP_BIAS if name.endswith(
                        "heatmap_conv2") else 0.0)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor
                ) -> Tuple[Dict[str, torch.Tensor], ...]:
        dt = self.dtype
        x = F.relu(self.bns[0](self.convs[0](x.permute(0, 3, 1, 2)))).to(dt)
        intermediate = self.blocks[0](x)
        ys = []
        for stack in range(self.num_stack):
            y = self.hourglasses[stack](intermediate)
            y = getattr(self, f"post_hg_{stack}")(y)
            y = F.relu(self.post_bns[stack](y)).to(dt)
            head = getattr(self, f"head_{stack}")(y)
            ys.append({k: v.permute(0, 2, 3, 1) for k, v in head.items()})
            if stack < self.num_stack - 1:
                c1, c2, bn1, bn2, block = self.reinject[stack]
                x1 = bn1(c1(y)).to(dt)
                x2 = bn2(c2(intermediate)).to(dt)
                intermediate = block(F.relu(x1 + x2))
        return tuple(ys)


MODELS.register("centernet", ObjectsAsPoints)
MODELS.register("objects_as_points", ObjectsAsPoints)
