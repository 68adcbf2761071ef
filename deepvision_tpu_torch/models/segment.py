"""U-Net semantic segmentation over the ResNet encoder (port of
deepvision_tpu/models/segment.py): a ResNet stem and stages (the port's
`BasicBlock` / `BottleneckBlock` and `_BN`), then a decoder that
upsamples nearest x2, concatenates the encoder skip of that stride and
refines with a 3x3 conv + BatchNorm + ReLU to width min(256, skip width),
ending in an f32 1x1 head: per-pixel class logits at the input size.

The public input is NHWC, and so are the logits (B, H, W, classes); inside,
NCHW. The dtype policy is the zoo's: convs at the compute dtype (bf16),
BatchNorm in f32 and an f32 head. Nearest x2 upsampling is
`repeat_interleave` on both axes (exact for factor 2: output row i reads
row i // 2, as `jax.image.resize(method="nearest")` does).

Children carry Flax's names: `stem_conv`, `dec<i>_conv`, `dec_full_conv`
and `head`, and the auto names `_BN_<i>` (the stem's first, then the
decoder's) and `<Block>_<i>`, so `utils/flax_convert.py` carries JAX's
variables over leaf for leaf. Init as in the JAX package: he_normal_fanout
conv kernels, each block's last BatchNorm scale zero, the head Flax's
default (lecun normal, zero bias).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..utils.registry import MODELS
from .common import (ComputeWeights, Conv, _add_children, at_least_f32,
                     he_normal_fanout_, lecun_normal_)
from .resnet import PAD1, BasicBlock, BottleneckBlock, _BN

# the widest decoder level: ResNet-50's 2048-wide stride-32 features would
# make the decoder dwarf the encoder
DECODER_MAX_WIDTH = 256


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 of H and W of NCHW `x`."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class UNetSegmenter(ComputeWeights, nn.Module):
    """ResNet-encoder U-Net: 7x7/2 stem -> BN -> 3x3/2 max pool -> stages
    -> nearest-x2 decoder with skip concats -> f32 1x1 logits at stride 1.
    `forward(x)` on (B, H, W, C) images, H and W divisible by
    2 ** (stages + 1) -> (B, H, W, num_classes) f32 logits."""

    def __init__(self, num_classes: int,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 block: type = BottleneckBlock, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, *, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        self.stem_conv = Conv(channels, width, 7, 2, dtype=dtype,
                              padding=((3, 3), (3, 3)))
        expansion = 4 if block is BottleneckBlock else 1
        blocks: List[nn.Module] = []
        skip_widths = [width]
        self.stage_ends: List[int] = []
        c = width
        for i, num_blocks in enumerate(stage_sizes):
            for j in range(num_blocks):
                features = width * 2 ** i
                blocks.append(block(c, features,
                                    strides=2 if i > 0 and j == 0 else 1,
                                    dtype=dtype))
                c = features * expansion
            self.stage_ends.append(len(blocks))
            skip_widths.append(c)
        bns = [_BN(width)]
        y = skip_widths.pop()
        for level, skip in enumerate(reversed(skip_widths)):
            out = min(DECODER_MAX_WIDTH, skip)
            self.add_module(f"dec{level}_conv", Conv(y + skip, out, 3,
                                                     dtype=dtype,
                                                     padding=PAD1))
            bns.append(_BN(out))
            y = out
        full = min(DECODER_MAX_WIDTH, width)
        self.dec_full_conv = Conv(y, full, 3, dtype=dtype, padding=PAD1)
        bns.append(_BN(full))
        # plain lists (registered once, under the auto names)
        self.layers = _add_children(self, bns[:1] + blocks + bns[1:])
        self.blocks = self.layers[1:1 + len(blocks)]
        self.dec_bns = self.layers[1 + len(blocks):]
        self.head = Conv(full, num_classes, 1, use_bias=True,
                         dtype=torch.float32)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv) and m is not self.head:
                    he_normal_fanout_(m.weight, generator)
                elif isinstance(m, _BN):
                    bn = m.layers[0]
                    bn.reset_parameters()
                    if m.zero_scale:
                        bn.weight.zero_()
            lecun_normal_(self.head.weight, generator)
            self.head.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        factor = 2 ** (len(self.stage_sizes) + 1)
        if x.shape[1] % factor or x.shape[2] % factor:
            # a misaligned size would only fail later as an opaque concat
            # shape error deep in the decoder: name the contract instead
            raise ValueError(
                f"UNetSegmenter with {len(self.stage_sizes)} stages needs "
                f"H/W divisible by {factor} (skip/upsample alignment), got "
                f"{x.shape[1]}x{x.shape[2]}")
        x = self.stem_conv(x.to(self.dtype).permute(0, 3, 1, 2))
        x = self.layers[0](x).to(self.dtype)
        skips = [x]                                   # stride 2
        x = nn.functional.max_pool2d(x, 3, 2, padding=1)
        for i, blk in enumerate(self.blocks, 1):
            x = blk(x)
            if i in self.stage_ends:
                skips.append(x)                       # strides 4, 8, ...
        y = skips.pop()
        for level, skip in enumerate(reversed(skips)):
            y = torch.cat([upsample2(y), skip.to(self.dtype)], dim=1)
            conv = getattr(self, f"dec{level}_conv")
            y = self.dec_bns[level](conv(y)).to(self.dtype)
        y = self.dec_bns[-1](self.dec_full_conv(upsample2(y))).to(self.dtype)
        return at_least_f32(self.head(y)).permute(0, 2, 3, 1)


MODELS.register("unet_resnet50", functools.partial(
    UNetSegmenter, stage_sizes=(3, 4, 6, 3), block=BottleneckBlock))
# the CPU-sized variant of the synthetic and digits recipes
MODELS.register("unet_small", functools.partial(
    UNetSegmenter, stage_sizes=(1, 1), block=BasicBlock, width=8))
