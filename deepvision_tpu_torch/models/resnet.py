"""ResNet family (port of deepvision_tpu/models/resnet.py): V1 with basic
or bottleneck blocks, and V2 with pre-activation bottlenecks.

The public input is NHWC, as in the JAX package; inside, NCHW. The dtype
policy is the JAX package's: convs at the compute dtype (bf16) from f32
master weights, BatchNorm in f32 (its statistics, scale, bias and running
averages always f32), an f32 head. Where each value is rounded matters to
the bf16 parity, so the order is Flax's:
- a BatchNorm followed by ReLU applies it in f32 (or in bf16 under
  `lowp_bn`) and drops to the compute dtype;
- a block's last BatchNorm returns f32 without ReLU, and the join is
  `relu(y.f32 + residual.f32).bf16` (in bf16 under `lowp_residual` or
  `lowp_bn`);
- V1's 3x3 convs pad 1 explicitly, the stem is 7x7/2 with pad 3 and the
  max pool 3x3/2 with pad 1 (pads with -inf); the space-to-depth stem is
  a 4x4/1 conv with pads (2, 1); V2's 3x3 conv is SAME, which at stride 2
  on an even size pads (0, 1);
- the global average pool is an f32 mean returned in the compute dtype.

Init: `he_normal_fanout` conv kernels (no conv has a bias), each block's
last BatchNorm scale zero, the head `normal(0.01)` with a zero bias.

Children carry Flax's names: `stem_conv` / `stem_conv_s2d`, `head`,
`proj`, and the auto names `<Block>_<i>`, `Conv_<i>`, `_BN_<i>` and, inside
each `_BN`, `BatchNorm_0` (in a V1 block the projection's BatchNorm is
`_BN_3`, created after the three of the main path), so
`utils/flax_convert.py` maps a Flax `params` + `batch_stats` pair onto
these modules leaf for leaf.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import MODELS
from .common import (BatchNorm, ComputeWeights, Conv, _add_children,
                     at_least_f32, global_avg_pool, he_normal_fanout_)

BN_EPS = 1e-5
PAD1 = ((1, 1), (1, 1))


class _BN(nn.Module):
    """Flax BatchNorm (momentum 0.9, eps 1e-5) and an optional ReLU; output
    in `dtype` (f32, or the compute dtype under `lowp_bn`)."""

    def __init__(self, features: int, relu: bool = True,
                 dtype: torch.dtype = torch.float32, zero_scale: bool = False):
        super().__init__()
        self.relu = relu
        self.zero_scale = zero_scale
        self.layers = _add_children(self, [BatchNorm(features, eps=BN_EPS,
                                                     dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layers[0](x)
        return F.relu(x) if self.relu else x


class _Block(nn.Module):
    """A V1 residual block from the (in, out, kernel, stride, padding) of
    its main path's convs: each conv followed by a `_BN`, the last one zero
    scaled and without ReLU; `proj`, a 1x1 conv and its `_BN` (`_BN_3` in a
    bottleneck, created after the main ones), projects the shortcut when
    its shape changes, or always with `always_project`."""

    def __init__(self, convs: Sequence[tuple], in_features: int,
                 out_features: int, strides: int, always_project: bool,
                 dtype: torch.dtype, lowp_residual: bool, lowp_bn: bool):
        super().__init__()
        self.dtype = dtype
        self.join = dtype if (lowp_residual or lowp_bn) else torch.float32
        bn_dtype = dtype if lowp_bn else torch.float32
        main: List[nn.Module] = []
        for i, (cin, cout, k, s, pad) in enumerate(convs):
            last = i == len(convs) - 1
            main += [Conv(cin, cout, k, s, dtype=dtype, padding=pad),
                     _BN(cout, relu=not last, dtype=bn_dtype,
                         zero_scale=last)]
        project = (always_project or in_features != out_features
                   or strides != 1)
        shortcut = ([_BN(out_features, relu=False, dtype=bn_dtype)]
                    if project else [])
        layers = _add_children(self, main + shortcut)
        self.main, self.proj_bn = layers[:len(main)], layers[len(main):]
        self.proj = (Conv(in_features, out_features, 1, strides, dtype=dtype)
                     if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        last = len(self.main) - 1
        for i, layer in enumerate(self.main):
            y = layer(y)
            if isinstance(layer, _BN) and i != last:
                y = y.to(self.dtype)
        residual = x
        if self.proj is not None:
            residual = self.proj_bn[0](self.proj(x))
        return F.relu(y.to(self.join) + residual.to(self.join)).to(self.dtype)


class BasicBlock(_Block):
    """Two 3x3 convs + identity/projection shortcut. It always strides its
    first conv: `stride_on_first` is accepted for a uniform API and does
    nothing, as in the JAX package."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16,
                 stride_on_first: bool = False, always_project: bool = False,
                 lowp_residual: bool = False, lowp_bn: bool = False):
        super().__init__([(in_features, features, 3, strides, PAD1),
                          (features, features, 3, 1, PAD1)],
                         in_features, features, strides, always_project,
                         dtype, lowp_residual, lowp_bn)


class BottleneckBlock(_Block):
    """1x1 reduce -> 3x3 -> 1x1 expand (x4) + projection shortcut; the
    stride on the 3x3, or on the first 1x1 with `stride_on_first`."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 expansion: int = 4, dtype: torch.dtype = torch.bfloat16,
                 stride_on_first: bool = False, always_project: bool = False,
                 lowp_residual: bool = False, lowp_bn: bool = False):
        out = features * expansion
        s1, s2 = (strides, 1) if stride_on_first else (1, strides)
        super().__init__([(in_features, features, 1, s1, "SAME"),
                          (features, features, 3, s2, PAD1),
                          (features, out, 1, 1, "SAME")],
                         in_features, out, strides, always_project, dtype,
                         lowp_residual, lowp_bn)


def _init(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """he_normal_fanout conv kernels, unit (or zero: a block's last)
    BatchNorm scales, zero biases, head normal(0.01), in module order."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                he_normal_fanout_(m.weight, generator)
            elif isinstance(m, _BN):
                bn = m.layers[0]
                bn.reset_parameters()
                if m.zero_scale:
                    bn.weight.zero_()
        model.head.weight.normal_(0.0, 0.01, generator=generator)
        model.head.bias.zero_()


def _global_pool_head(model, x: torch.Tensor) -> torch.Tensor:
    """f32 mean over H, W returned in the compute dtype (jnp.mean on bf16),
    then the f32 head (f64 in an f64 model)."""
    x = global_avg_pool(x, model.dtype)
    return F.linear(at_least_f32(x), model.head.weight, model.head.bias)


class ResNet(ComputeWeights, nn.Module):
    """V1 ResNet: 7x7/2 stem -> BN -> 3x3/2 max pool -> 4 stages -> global
    average pool -> f32 Dense. `forward(x)` on (B, H, W, C) images ->
    (B, num_classes) f32 logits."""

    def __init__(self, stage_sizes: Sequence[int], block: type = BottleneckBlock,
                 num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 stride_on_first: bool = False,
                 project_first_blocks: bool = False,
                 stem_space_to_depth: bool = False,
                 lowp_residual: bool = False, lowp_bn: bool = False, *,
                 channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.stem_space_to_depth = stem_space_to_depth
        if stem_space_to_depth:
            self.stem_conv_s2d = Conv(4 * channels, width, 4, 1, dtype=dtype,
                                      padding=((2, 1), (2, 1)))
        else:
            self.stem_conv = Conv(channels, width, 7, 2, dtype=dtype,
                                  padding=((3, 3), (3, 3)))
        blocks: List[nn.Module] = [
            _BN(width, dtype=dtype if lowp_bn else torch.float32)]
        expansion = 4 if block is BottleneckBlock else 1
        c = width
        for i, num_blocks in enumerate(stage_sizes):
            for j in range(num_blocks):
                features = width * 2 ** i
                blocks.append(block(
                    c, features, strides=2 if i > 0 and j == 0 else 1,
                    dtype=dtype, stride_on_first=stride_on_first,
                    always_project=project_first_blocks and j == 0,
                    lowp_residual=lowp_residual, lowp_bn=lowp_bn))
                c = features * expansion
        self.layers = _add_children(self, blocks)     # stem BN, blocks
        self.head = nn.Linear(c, num_classes)
        _init(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem_space_to_depth:
            n, h, w, c = x.shape
            x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            x = self.stem_conv_s2d(x.reshape(n, h // 2, w // 2, 4 * c)
                                   .permute(0, 3, 1, 2))
        else:
            x = self.stem_conv(x.permute(0, 3, 1, 2))
        x = self.layers[0](x).to(self.dtype)
        x = F.max_pool2d(x, 3, 2, padding=1)
        for blk in self.layers[1:]:
            x = blk(x)
        return _global_pool_head(self, x)


MODELS.register("resnet34", functools.partial(
    ResNet, stage_sizes=(3, 4, 6, 3), block=BasicBlock))
MODELS.register("resnet50", functools.partial(
    ResNet, stage_sizes=(3, 4, 6, 3), block=BottleneckBlock))
MODELS.register("resnet101", functools.partial(
    ResNet, stage_sizes=(3, 4, 23, 3), block=BottleneckBlock))
MODELS.register("resnet152", functools.partial(
    ResNet, stage_sizes=(3, 8, 36, 3), block=BottleneckBlock))
# the same parameters as resnet50, with bf16 BatchNorm outputs and bf16
# residual joins (the JAX package's HBM-traffic experiments)
MODELS.register("resnet50_lean", functools.partial(
    ResNet, stage_sizes=(3, 4, 6, 3), block=BottleneckBlock,
    lowp_residual=True, lowp_bn=True))


class PreActBottleneck(nn.Module):
    """Pre-activation bottleneck: BN-ReLU, then 1x1 -> BN-ReLU -> 3x3
    (SAME) -> BN-ReLU -> 1x1, plus the shortcut (projected from the
    pre-activation when the shape changes); the join is in bf16."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 expansion: int = 4, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        out = features * expansion
        self.proj = (Conv(in_features, out, 1, strides, dtype=dtype)
                     if in_features != out or strides != 1 else None)
        self.bns = _add_children(self, [_BN(in_features), _BN(features),
                                        _BN(features)])
        self.convs = _add_children(self, [
            Conv(in_features, features, 1, dtype=dtype),
            Conv(features, features, 3, strides, dtype=dtype),
            Conv(features, out, 1, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = self.bns[0](x).to(self.dtype)
        residual = x if self.proj is None else self.proj(pre)
        y = self.convs[0](pre)
        y = self.bns[1](y).to(self.dtype)
        y = self.convs[1](y)
        y = self.bns[2](y).to(self.dtype)
        y = self.convs[2](y)
        return (y + residual).to(self.dtype)


class ResNetV2(ComputeWeights, nn.Module):
    """V2 ResNet: 7x7/2 stem -> max pool -> pre-activation stages ->
    BN-ReLU -> global average pool -> f32 Dense."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16, *,
                 channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = Conv(channels, width, 7, 2, dtype=dtype,
                              padding=((3, 3), (3, 3)))
        blocks: List[nn.Module] = []
        c = width
        for i, num_blocks in enumerate(stage_sizes):
            for j in range(num_blocks):
                features = width * 2 ** i
                blocks.append(PreActBottleneck(
                    c, features, strides=2 if i > 0 and j == 0 else 1,
                    dtype=dtype))
                c = features * 4
        self.blocks = _add_children(self, blocks)
        self.final_bn = _add_children(self, [_BN(c)])
        self.head = nn.Linear(c, num_classes)
        _init(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.stem_conv(x.to(self.dtype).permute(0, 3, 1, 2))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for blk in self.blocks:
            x = blk(x)
        return _global_pool_head(self, self.final_bn[0](x).to(self.dtype))


MODELS.register("resnet50v2", functools.partial(ResNetV2,
                                                stage_sizes=(3, 4, 6, 3)))
