"""GAN models (port of deepvision_tpu/models/gan.py): the DCGAN generator
and discriminator (MNIST, 28 px) and the CycleGAN generator (9 residual
blocks, reflection pads) and 70x70 PatchGAN discriminator.

All compute in f32, as in the JAX package. The public input and output
are NHWC; inside, NCHW. Keras constants as there: BatchNorm with Flax
momentum 0.99 and epsilon 1e-3 (torch momentum 0.01), LeakyReLU 0.3 in
DCGAN and 0.2 in the PatchGAN, and BatchNorm where the reference has it
(the CycleGAN paper uses instance norm; the reference chose BatchNorm).

Children register under Flax's auto names in Flax's creation order
(`Dense_0`, `BatchNorm_<i>`, `ConvTranspose_<i>`, `Conv_<i>`,
`CycleGANResBlock_<i>`), so `utils/flax_convert.py` carries JAX's
variables over leaf for leaf. Init is Flax's default: lecun-normal
kernels, zero biases, unit BatchNorm scales.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import MODELS
from .common import (BatchNorm, Conv, ConvTranspose, Dense, Dropout,
                     _add_children, at_least_f32, flatten_nhwc,
                     lecun_normal_, out_size, reflect_pad)

BN_MOMENTUM = 0.99
BN_EPS = 1e-3


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def _init(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Flax's default init, in module order."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv, ConvTranspose, Dense)):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class DCGANGenerator(nn.Module):
    """100-d noise -> (28, 28, 1) tanh image: Dense 7*7*256 -> BN ->
    LeakyReLU -> ConvTranspose 128 (5x5, s1) -> 64 (s2) -> 1 (s2), BN and
    LeakyReLU between, no biases."""

    def __init__(self, noise_dim: int = 100,
                 dtype: torch.dtype = torch.float32, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.noise_dim = noise_dim
        self.dense = _add_children(self, [
            Dense(noise_dim, 7 * 7 * 256, dtype=dtype, use_bias=False)])
        self.bns = _add_children(self, [_bn(7 * 7 * 256), _bn(128), _bn(64)])
        self.convs = _add_children(self, [
            ConvTranspose(256, 128, 5, 1, dtype=dtype),
            ConvTranspose(128, 64, 5, 2, dtype=dtype),
            ConvTranspose(64, 1, 5, 2, dtype=dtype)])
        _init(self, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.dense[0](z)
        x = F.leaky_relu(self.bns[0](x), 0.3).to(self.dtype)
        x = _nchw(x.reshape(x.shape[0], 7, 7, 256))
        for i, (conv, size) in enumerate(zip(self.convs, (7, 14, 28))):
            x = conv(x)
            if tuple(x.shape[2:]) != (size, size):
                raise AssertionError(f"ConvTranspose_{i} gave {x.shape}")
            if i < 2:
                x = F.leaky_relu(self.bns[i + 1](x), 0.3).to(self.dtype)
        return torch.tanh(at_least_f32(_nhwc(x)))


class DCGANDiscriminator(nn.Module):
    """(28, 28, 1) image -> one real/fake logit: conv 64 and 128 (5x5, s2,
    SAME) each with LeakyReLU 0.3 and Dropout 0.3, then Dense 1 over the
    NHWC flatten. `forward(x, generator)`: dropout draws its masks from
    `generator` in train mode."""

    def __init__(self, dtype: torch.dtype = torch.float32, *,
                 channels: int = 1, image_size: int = 28,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.convs = _add_children(self, [
            Conv(channels, 64, 5, 2, use_bias=True, dtype=dtype),
            Conv(64, 128, 5, 2, use_bias=True, dtype=dtype)])
        self.dropouts = _add_children(self, [Dropout(0.3), Dropout(0.3)])
        size = out_size(out_size(image_size, 5, 2, "SAME"), 5, 2, "SAME")
        self.dense = _add_children(self, [
            Dense(size * size * 128, 1, dtype=torch.float32)])
        _init(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _nchw(x.to(self.dtype))
        for conv, drop in zip(self.convs, self.dropouts):
            x = drop(F.leaky_relu(conv(x), 0.3), generator)
        return self.dense[0](at_least_f32(flatten_nhwc(x)))


class CycleGANResBlock(nn.Module):
    """Reflect-padded 3x3 residual block: pad 1 -> conv -> BN -> ReLU ->
    pad 1 -> conv -> BN, plus the input."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs = _add_children(self, [
            Conv(features, features, 3, dtype=dtype, padding="VALID"),
            Conv(features, features, 3, dtype=dtype, padding="VALID")])
        self.bns = _add_children(self, [_bn(features), _bn(features)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convs[0](reflect_pad(x, 1))
        y = F.relu(self.bns[0](y)).to(self.dtype)
        y = self.convs[1](reflect_pad(y, 1))
        return x + self.bns[1](y).to(self.dtype)


class CycleGANGenerator(nn.Module):
    """c7s1-64, d128, d256, R256 x n_blocks, u128, u64, c7s1-3 with
    reflection pads; NHWC image in [-1, 1] -> NHWC tanh image."""

    def __init__(self, n_blocks: int = 9, dtype: torch.dtype = torch.float32,
                 *, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        # Flax's creation order: Conv_0, BatchNorm_0, Conv_1, BatchNorm_1,
        # Conv_2, BatchNorm_2, the blocks, ConvTranspose_0, BatchNorm_3,
        # ConvTranspose_1, BatchNorm_4, Conv_3 (the f32 output conv)
        self.encode = _add_children(self, [
            Conv(channels, 64, 7, dtype=dtype, padding="VALID"),
            Conv(64, 128, 3, 2, dtype=dtype),
            Conv(128, 256, 3, 2, dtype=dtype),
            Conv(64, 3, 7, use_bias=True, dtype=torch.float32,
                 padding="VALID")])
        self.blocks = _add_children(self, [CycleGANResBlock(256, dtype)
                                           for _ in range(n_blocks)])
        self.decode = _add_children(self, [
            ConvTranspose(256, 128, 3, 2, dtype=dtype),
            ConvTranspose(128, 64, 3, 2, dtype=dtype)])
        self.bns: List[BatchNorm] = _add_children(
            self, [_bn(f) for f in (64, 128, 256, 128, 64)])
        _init(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = reflect_pad(_nchw(x.to(self.dtype)), 3)
        for conv, bn in zip(self.encode[:3], self.bns[:3]):
            x = F.relu(bn(conv(x))).to(self.dtype)
        for block in self.blocks:
            x = block(x)
        for conv, bn in zip(self.decode, self.bns[3:]):
            x = F.relu(bn(conv(x))).to(self.dtype)
        x = self.encode[3](reflect_pad(x, 3))
        return torch.tanh(_nhwc(x))


class PatchGANDiscriminator(nn.Module):
    """70x70 PatchGAN: (H, W, 3) -> (H/8, W/8, 1) patch logits: conv 64
    (4x4, s2, bias) -> LeakyReLU 0.2 -> conv 128 (s2), 256 (s2), 512 (s1),
    each BN and LeakyReLU 0.2 -> conv 1 (s1, bias, f32); every conv SAME."""

    def __init__(self, dtype: torch.dtype = torch.float32, *,
                 channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.convs = _add_children(self, [
            Conv(channels, 64, 4, 2, use_bias=True, dtype=dtype),
            Conv(64, 128, 4, 2, dtype=dtype), Conv(128, 256, 4, 2, dtype=dtype),
            Conv(256, 512, 4, 1, dtype=dtype),
            Conv(512, 1, 4, 1, use_bias=True, dtype=torch.float32)])
        self.bns = _add_children(self, [_bn(128), _bn(256), _bn(512)])
        _init(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.convs[0](_nchw(x.to(self.dtype))), 0.2)
        for conv, bn in zip(self.convs[1:4], self.bns):
            x = F.leaky_relu(bn(conv(x)), 0.2).to(self.dtype)
        return _nhwc(self.convs[4](x))


MODELS.register("dcgan_generator", DCGANGenerator)
MODELS.register("dcgan_discriminator", DCGANDiscriminator)
MODELS.register("cyclegan_generator", CycleGANGenerator)
MODELS.register("patchgan_discriminator", PatchGANDiscriminator)
# family aliases so the dcgan/cyclegan configs resolve; the GAN trainers
# build the generator and discriminator pairs themselves (core/gan.py)
MODELS.register("dcgan", DCGANGenerator)
MODELS.register("cyclegan", CycleGANGenerator)
