"""Inception V1 / GoogLeNet and Inception V3 (port of
deepvision_tpu/models/inception.py).

V1: a 7x7/2 stem (pad 3) -> SAME 3x3/2 max pool -> LRN -> 1x1 and 3x3
ConvBNs -> LRN -> max pool, nine 4-branch inception modules (3a-5b, SAME
3x3/2 max pools after 3b and 4e), global average pool -> dropout 0.4 ->
f32 head. In train mode it also returns two auxiliary heads (on 4a's and
4d's outputs: 5x5/3 average pool -> 1x1 ConvBN 128 -> flatten -> Dense
1024 -> ReLU -> dropout 0.7 -> f32 Dense), as (main, aux1, aux2).
`use_bn=False` is the BN-free stack (convs with biases) with torch's LRN
windows.

V3: the VALID stem (3x3/2, 3x3, 3x3 SAME, 3x3/2 max pool, 1x1, 3x3, 3x3/2
max pool), InceptionA x3, ReductionA, InceptionB (factorized 7x7) x4,
ReductionB, InceptionC x2, global average pool -> dropout 0.5 -> f32 head;
in train mode also the aux head on the last InceptionB's output (5x5/3
average pool -> 1x1 ConvBN 128 -> ConvBN 768 with a kernel the size of the
pooled map, VALID -> mean -> f32 Dense), as (main, aux).

The public input is NHWC; inside, NCHW. Each ConvBN convolves at the
compute dtype, normalizes in f32, applies ReLU in f32 and drops to the
compute dtype; branches concatenate on channels in the order y1, y2, y3,
pool. Pools within modules are SAME at stride 1 (the average pool counts
the zero padding, as flax's does).

Sizes that Flax infers from the first input follow here from `image_size`:
V1's aux Dense takes the flattened pooled map; V3's aux kernel is the
pooled map (5x5 at 299 px, 1x1 at 107-139 px). Where the aux head has no
input left (V1 below 65 px, V3 below 107 px) the model is built without
it: eval mode works (V3 from 75 px), and train mode raises a ValueError
naming the smallest size, where the JAX model's init divides by zero.

Children carry the JAX model's names (`stem1`, `mod3a`, ..., `ConvBN_<i>`,
`InceptionA_<i>`, ..., `head`, `aux1`, `aux2`, `aux`), so
`utils/flax_convert.py` maps a Flax `params` + `batch_stats` pair onto
this module leaf for leaf. Init: `he_normal_fanout` conv kernels (zero
biases under `use_bn=False`), unit BatchNorm scales, lecun_normal dense
kernels with zero biases.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import MODELS
from .common import (ComputeWeights, ConvBN, Dense, Dropout, _add_children,
                     avg_pool, flatten_nhwc, global_avg_pool, lecun_normal_,
                     lrn, max_pool, out_size)

STEM_PAD = ((3, 3), (3, 3))
# (b1, b2_reduce, b2, b3_reduce, b3, b4) per module: the paper's Table 1
V1_MODULES = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}
V1_POOL_AFTER = ("3b", "4e")


def _init_dense(modules, generator) -> None:
    with torch.no_grad():
        for m in modules:
            lecun_normal_(m.weight, generator)
            m.bias.zero_()


def _smallest(ok, start: int) -> int:
    """The smallest size from `start` up at which `ok(size)` holds."""
    return next(s for s in range(start, 10**4) if ok(s))


class InceptionModule(nn.Module):
    """1x1 / 1x1 -> 3x3 / 1x1 -> 5x5 / 3x3 max pool -> 1x1, concatenated;
    ConvBN_0..5 in that order of creation."""

    def __init__(self, in_features: int, b1: int, b2_reduce: int, b2: int,
                 b3_reduce: int, b3: int, b4: int, use_bn: bool,
                 dtype: torch.dtype, generator: Optional[torch.Generator]):
        super().__init__()
        cb = functools.partial(ConvBN, use_bn=use_bn, dtype=dtype,
                               generator=generator)
        self.convs = _add_children(self, [
            cb(in_features, b1, 1), cb(in_features, b2_reduce, 1),
            cb(b2_reduce, b2, 3), cb(in_features, b3_reduce, 1),
            cb(b3_reduce, b3, 5), cb(in_features, b4, 1)])
        self.features = b1 + b2 + b3 + b4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convs
        y4 = c[5](max_pool(x, 3, 1, "SAME"))
        return torch.cat([c[0](x), c[2](c[1](x)), c[4](c[3](x)), y4], dim=1)


class AuxClassifier(nn.Module):
    """5x5/3 avg pool -> 1x1 ConvBN(128) -> flatten -> Dense 1024 -> ReLU
    -> dropout 0.7 -> f32 Dense; `side` is the pooled map's side."""

    def __init__(self, in_features: int, side: int, num_classes: int,
                 use_bn: bool, dtype: torch.dtype,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.convs = _add_children(self, [ConvBN(
            in_features, 128, 1, use_bn=use_bn, dtype=dtype,
            generator=generator)])
        self.denses = _add_children(self, [
            Dense(side * side * 128, 1024, dtype=dtype),
            Dense(1024, num_classes)])
        self.dropout = Dropout(0.7)
        _init_dense(self.denses, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        x = flatten_nhwc(self.convs[0](avg_pool(x, 5, 3)))
        x = self.dropout(F.relu(self.denses[0](x)), generator)
        return self.denses[1](x)


def _v1_aux_side(image_size: int) -> int:
    """Side of V1's pooled aux map: 4a's output after the 5x5/3 pool."""
    size = out_size(image_size, 7, 2, (3, 3))
    for _ in range(3):                  # the SAME 3x3/2 max pools
        size = out_size(size, 3, 2, "SAME")
    return out_size(size, 5, 3)


class _AuxModel(ComputeWeights, nn.Module):
    """What V1 and V3 share: the aux heads only in train mode, and the
    refusal of train mode where they could not be built."""

    aux_min_size: int

    def _outputs(self, main: torch.Tensor, aux) -> object:
        if not self.training or not self.use_aux:
            return main
        if self.aux_heads is None:
            raise ValueError(
                f"{type(self).__name__} in train mode with its aux heads "
                f"needs at least {self.aux_min_size} px (built for "
                f"{self.image_size} px); aux=False trains without them")
        return (main, *aux())


@MODELS.register("googlenet")
@MODELS.register("inception_v1")
class InceptionV1(_AuxModel):
    """`forward(x)` on (B, H, W, C) images -> (B, num_classes) f32 logits,
    and in train mode (main, aux1, aux2)."""

    def __init__(self, num_classes: int = 1000, aux: bool = True,
                 use_bn: bool = True, dtype: torch.dtype = torch.bfloat16, *,
                 image_size: int = 224, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.use_aux, self.use_bn = dtype, aux, use_bn
        self.image_size = image_size
        self.aux_min_size = _smallest(lambda s: _v1_aux_side(s) >= 1, 1)
        cb = functools.partial(ConvBN, use_bn=use_bn, dtype=dtype,
                               generator=generator)
        self.stem1 = cb(channels, 64, 7, 2, padding=STEM_PAD)
        self.stem2a = cb(64, 64, 1)
        self.stem2b = cb(64, 192, 3)
        self.mods = []
        c = 192
        for name, widths in V1_MODULES.items():
            m = InceptionModule(c, *widths, use_bn=use_bn, dtype=dtype,
                                generator=generator)
            self.add_module(f"mod{name}", m)
            self.mods.append((name, m))
            c = m.features
        self.dropout = Dropout(0.4)
        self.head = Dense(c, num_classes)
        side = _v1_aux_side(image_size)
        self.aux_heads = None
        if aux and side >= 1:
            self.aux1 = AuxClassifier(512, side, num_classes, use_bn, dtype,
                                      generator)
            self.aux2 = AuxClassifier(528, side, num_classes, use_bn, dtype,
                                      generator)
            self.aux_heads = (self.aux1, self.aux2)
        _init_dense([self.head], generator)

    def _lrn(self, x: torch.Tensor) -> torch.Tensor:
        return lrn(x) if self.use_bn else lrn(x, torch_size=x.shape[1])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        x = self.stem1(x.to(self.dtype).permute(0, 3, 1, 2))
        x = self._lrn(max_pool(x, 3, 2, "SAME"))
        x = self._lrn(self.stem2b(self.stem2a(x)))
        x = max_pool(x, 3, 2, "SAME")
        taps = {}
        for name, module in self.mods:
            x = module(x)
            taps[name] = x
            if name in V1_POOL_AFTER:
                x = max_pool(x, 3, 2, "SAME")
        x = global_avg_pool(x, self.dtype)
        main = self.head(self.dropout(x, generator))
        return self._outputs(main, lambda: (
            self.aux1(taps["4a"], generator),
            self.aux2(taps["4d"], generator)))


# -- Inception V3 ------------------------------------------------------------

def _cat(*ys: torch.Tensor) -> torch.Tensor:
    return torch.cat(ys, dim=1)


class _Block(nn.Module):
    """A V3 block: its ConvBNs (`ConvBN_<i>` in creation order) from
    (in, out, kernel, strides, padding) rows."""

    def __init__(self, rows: Sequence[tuple], dtype: torch.dtype,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.convs = _add_children(self, [
            ConvBN(i, o, k, s, padding=p, dtype=dtype, generator=generator)
            for i, o, k, s, p in rows])


class InceptionA(_Block):
    def __init__(self, cin: int, pool_features: int, dtype, generator):
        super().__init__([(cin, 64, 1, 1, "SAME"), (cin, 48, 1, 1, "SAME"),
                          (48, 64, 5, 1, "SAME"), (cin, 64, 1, 1, "SAME"),
                          (64, 96, 3, 1, "SAME"), (96, 96, 3, 1, "SAME"),
                          (cin, pool_features, 1, 1, "SAME")],
                         dtype, generator)
        self.features = 224 + pool_features

    def forward(self, x):
        c = self.convs
        return _cat(c[0](x), c[2](c[1](x)), c[5](c[4](c[3](x))),
                    c[6](avg_pool(x, 3, 1, "SAME")))


class ReductionA(_Block):
    def __init__(self, cin: int, dtype, generator):
        super().__init__([(cin, 384, 3, 2, "VALID"), (cin, 64, 1, 1, "SAME"),
                          (64, 96, 3, 1, "SAME"), (96, 96, 3, 2, "VALID")],
                         dtype, generator)
        self.features = 384 + 96 + cin

    def forward(self, x):
        c = self.convs
        return _cat(c[0](x), c[3](c[2](c[1](x))), max_pool(x, 3, 2))


class InceptionB(_Block):
    """The factorized 7x7 block."""

    def __init__(self, cin: int, c7: int, dtype, generator):
        super().__init__([(cin, 192, 1, 1, "SAME"), (cin, c7, 1, 1, "SAME"),
                          (c7, c7, (1, 7), 1, "SAME"),
                          (c7, 192, (7, 1), 1, "SAME"),
                          (cin, c7, 1, 1, "SAME"),
                          (c7, c7, (7, 1), 1, "SAME"),
                          (c7, c7, (1, 7), 1, "SAME"),
                          (c7, c7, (7, 1), 1, "SAME"),
                          (c7, 192, (1, 7), 1, "SAME"),
                          (cin, 192, 1, 1, "SAME")], dtype, generator)
        self.features = 768

    def forward(self, x):
        c = self.convs
        b3 = x
        for conv in c[4:9]:
            b3 = conv(b3)
        return _cat(c[0](x), c[3](c[2](c[1](x))), b3,
                    c[9](avg_pool(x, 3, 1, "SAME")))


class ReductionB(_Block):
    def __init__(self, cin: int, dtype, generator):
        super().__init__([(cin, 192, 1, 1, "SAME"),
                          (192, 320, 3, 2, "VALID"),
                          (cin, 192, 1, 1, "SAME"),
                          (192, 192, (1, 7), 1, "SAME"),
                          (192, 192, (7, 1), 1, "SAME"),
                          (192, 192, 3, 2, "VALID")], dtype, generator)
        self.features = 320 + 192 + cin

    def forward(self, x):
        c = self.convs
        return _cat(c[1](c[0](x)), c[5](c[4](c[3](c[2](x)))),
                    max_pool(x, 3, 2))


class InceptionC(_Block):
    """The expanded filter bank: ConvBN_0..8, each split's (1, 3) conv
    created before its (3, 1)."""

    def __init__(self, cin: int, dtype, generator):
        super().__init__([(cin, 320, 1, 1, "SAME"), (cin, 384, 1, 1, "SAME"),
                          (384, 384, (1, 3), 1, "SAME"),
                          (384, 384, (3, 1), 1, "SAME"),
                          (cin, 448, 1, 1, "SAME"), (448, 384, 3, 1, "SAME"),
                          (384, 384, (1, 3), 1, "SAME"),
                          (384, 384, (3, 1), 1, "SAME"),
                          (cin, 192, 1, 1, "SAME")], dtype, generator)
        self.features = 2048

    def forward(self, x):
        c = self.convs
        b2 = c[1](x)
        b3 = c[5](c[4](x))
        return _cat(c[0](x), c[2](b2), c[3](b2), c[6](b3), c[7](b3),
                    c[8](avg_pool(x, 3, 1, "SAME")))


class AuxClassifierV3(nn.Module):
    """5x5/3 avg pool -> 1x1 ConvBN(128) -> ConvBN(768) with a `side` x
    `side` kernel, VALID -> mean -> f32 Dense."""

    def __init__(self, in_features: int, side: int, num_classes: int,
                 dtype: torch.dtype, generator: Optional[torch.Generator]):
        super().__init__()
        self.dtype = dtype
        self.convs = _add_children(self, [
            ConvBN(in_features, 128, 1, dtype=dtype, generator=generator),
            ConvBN(128, 768, side, padding="VALID", dtype=dtype,
                   generator=generator)])
        self.denses = _add_children(self, [Dense(768, num_classes)])
        _init_dense(self.denses, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convs[1](self.convs[0](avg_pool(x, 5, 3)))
        return self.denses[0](global_avg_pool(x, self.dtype))


def _v3_sizes(image_size: int) -> Tuple[int, int]:
    """(side of the aux head's pooled map, side of the last map) of V3."""
    s = out_size(image_size, 3, 2)          # stem
    s = out_size(s, 3)
    s = out_size(out_size(s, 3, 2), 1)      # max pool, 1x1
    s = out_size(out_size(s, 3), 3, 2)      # 3x3, max pool
    s = out_size(s, 3, 2)                   # ReductionA
    aux = out_size(s, 5, 3)
    return aux, out_size(s, 3, 2)           # ReductionB


@MODELS.register("inception_v3")
class InceptionV3(_AuxModel):
    """`forward(x)` on (B, H, W, C) images -> (B, num_classes) f32 logits,
    and in train mode (main, aux). 299 px is canonical; eval needs at least
    75 px, train mode with the aux head 107."""

    def __init__(self, num_classes: int = 1000, aux: bool = True,
                 dtype: torch.dtype = torch.bfloat16, *,
                 image_size: int = 299, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        aux_side, last = _v3_sizes(image_size)
        if last < 1:
            raise ValueError(f"Inception V3 needs at least "
                             f"{_smallest(lambda s: _v3_sizes(s)[1] >= 1, 1)}"
                             f" px: at {image_size} px ReductionB has no "
                             f"output")
        self.dtype, self.use_aux, self.image_size = dtype, aux, image_size
        self.aux_min_size = _smallest(lambda s: _v3_sizes(s)[0] >= 1, 1)
        cb = functools.partial(ConvBN, dtype=dtype, generator=generator)
        stem = [cb(channels, 32, 3, 2, padding="VALID"),
                cb(32, 32, 3, padding="VALID"), cb(32, 64, 3),
                cb(64, 80, 1, padding="VALID"),
                cb(80, 192, 3, padding="VALID")]
        blocks: List[nn.Module] = []
        c = 192
        for make in ([functools.partial(InceptionA, pool_features=p)
                      for p in (32, 64, 64)] + [ReductionA]
                     + [functools.partial(InceptionB, c7=c7)
                        for c7 in (128, 160, 160, 192)]
                     + [ReductionB, InceptionC, InceptionC]):
            blocks.append(make(c, dtype=dtype, generator=generator))
            c = blocks[-1].features
        layers = _add_children(self, stem + blocks)
        self.stem, self.blocks = layers[:5], layers[5:]
        self.dropout = Dropout(0.5)
        self.head = Dense(c, num_classes)
        _init_dense([self.head], generator)
        self.aux_heads = None
        if aux and aux_side >= 1:
            self.aux_heads = (AuxClassifierV3(768, aux_side, num_classes,
                                              dtype, generator),)
            self.add_module("aux", self.aux_heads[0])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        s = self.stem
        x = s[2](s[1](s[0](x.to(self.dtype).permute(0, 3, 1, 2))))
        x = max_pool(s[4](s[3](max_pool(x, 3, 2))), 3, 2)
        aux_in = None
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i == 7:                   # the last InceptionB
                aux_in = x
        x = global_avg_pool(x, self.dtype)
        main = self.head(self.dropout(x, generator))
        return self._outputs(main, lambda: (self.aux_heads[0](aux_in),))
