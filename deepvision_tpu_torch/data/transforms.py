"""The flat loader's transform stacks (own copy of
deepvision_tpu/data/transforms.py:27-210): Rescale, RandomCrop,
CenterCrop, RandomHorizontalFlip, ColorJitter, ToFloat and Normalize,
composed into the reference's train and eval stacks and the
`host_decode_*` halves of `--device-augment`.

The JAX transforms run per image in numpy after a PIL decode. Here a
stack draws each image's randomness on the host, in the JAX stack's
order from the image's own generator (flip, crop top, crop left, the
three jitter factors), so a seed gives the JAX package's draws; the
geometry becomes a `data/util.py::Plan` that one resample launch applies
to the whole batch on the card (PIL's BILINEAR becomes the antialiased
bilinear, rounded to uint8 as PIL's output is), and the jitter and the
normalisation run batched on the device (`Stack.finish`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.config import IMAGENET_MEAN, IMAGENET_STD, decode_image_size
from .util import Plan

Size = Union[int, Tuple[int, int]]


class Rescale:
    """Resize: int = shorter side (aspect kept), tuple = exact (h, w)."""

    def __init__(self, output_size: Size):
        self.output_size = output_size

    def size(self, h: int, w: int) -> Tuple[int, int]:
        s = self.output_size
        if isinstance(s, int):
            if h < w:
                return s, int(round(w * s / h))
            return int(round(h * s / w)), s
        return tuple(s)


class RandomCrop:
    """Uniform random (h, w) crop."""

    def __init__(self, output_size: Size):
        self.size = ((output_size, output_size)
                     if isinstance(output_size, int) else output_size)

    def window(self, h: int, w: int, rng: np.random.Generator
               ) -> Tuple[int, int]:
        ch, cw = self.size
        top = int(rng.integers(0, h - ch + 1))
        left = int(rng.integers(0, w - cw + 1))
        return top, left


class CenterCrop:
    """Center (h, w) crop."""

    def __init__(self, output_size: Size):
        self.size = ((output_size, output_size)
                     if isinstance(output_size, int) else output_size)

    def window(self, h: int, w: int, rng=None) -> Tuple[int, int]:
        ch, cw = self.size
        return (h - ch) // 2, (w - cw) // 2


class RandomHorizontalFlip:
    """Left-right flip with probability `prob`."""

    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def draw(self, rng: np.random.Generator) -> bool:
        return bool(rng.random() < self.prob)


class ColorJitter:
    """Brightness, contrast and saturation factors drawn uniformly from
    [max(0, 1 - x), 1 + x], applied on [0, 255] and clipped."""

    def __init__(self, brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    def draw(self, rng: np.random.Generator) -> Tuple[float, float, float]:
        out = []
        for x in (self.brightness, self.contrast, self.saturation):
            out.append(float(rng.uniform(max(0.0, 1.0 - x), 1.0 + x))
                       if x else 1.0)
        return tuple(out)

    @staticmethod
    def apply(images: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
        """A (B, H, W, 3) float batch, factors (B, 3): brightness, then
        contrast about each image's channel means, then saturation about
        each pixel's channel mean, then clip (the JAX order)."""
        f = factors.to(images.device, torch.float32)[:, None, None, :]
        img = images * f[..., 0:1]
        mean = img.mean(dim=(1, 2), keepdim=True)
        img = (img - mean) * f[..., 1:2] + mean
        gray = img.mean(dim=3, keepdim=True)
        img = (img - gray) * f[..., 2:3] + gray
        return img.clamp(0.0, 255.0)


class Normalize:
    """Channelwise (x - mean) / std on [0, 1] floats."""

    def __init__(self, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD):
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(s) for s in std)

    def apply(self, images: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(self.mean, device=images.device)
        std = torch.tensor(self.std, device=images.device)
        return (images - mean) / std


class Draw(NamedTuple):
    """One image's draws: its plan and its jitter factors (or None)."""
    plan: Plan
    jitter: Optional[Tuple[float, float, float]]


class Stack:
    """Rescale → [flip] → crop → [jitter] → [float and normalize]: the
    shape of every stack the flat loader uses. `uint8` stacks (the
    host-decode halves) stop after the crop."""

    def __init__(self, rescale: Rescale, crop, *,
                 flip: Optional[RandomHorizontalFlip] = None,
                 jitter: Optional[ColorJitter] = None,
                 normalize: Optional[Normalize] = None):
        self.rescale = rescale
        self.crop = crop
        self.flip = flip
        self.jitter = jitter
        self.normalize = normalize

    @property
    def out_size(self) -> Tuple[int, int]:
        return tuple(self.crop.size)

    @property
    def uint8(self) -> bool:
        return self.normalize is None

    def draw(self, shape: Tuple[int, int],
             rng: Optional[np.random.Generator]) -> Draw:
        """The image's plan and jitter, drawn in the JAX stack's order."""
        h, w = shape
        rh, rw = self.rescale.size(h, w)
        flip = self.flip.draw(rng) if self.flip is not None else False
        window = self.crop.window(rh, rw, rng)
        jitter = self.jitter.draw(rng) if self.jitter is not None else None
        return Draw(Plan((0, 0, h, w), (rh, rw), window, flip), jitter)

    def finish(self, images: torch.Tensor, draws: Sequence[Draw]
               ) -> torch.Tensor:
        """The batched tail on the device: the resampled uint8 batch →
        jitter → /255 → normalize (or the uint8 batch as it is)."""
        if self.uint8:
            return images
        x = images.to(torch.float32)
        if self.jitter is not None:
            factors = torch.tensor([d.jitter for d in draws],
                                   dtype=torch.float32)
            x = ColorJitter.apply(x, factors)
        return self.normalize.apply(x / 255.0)


def train_transform(image_size: int = 224) -> Stack:
    """Rescale(256) → flip → RandomCrop(224) → jitter → float →
    normalize (`ResNet/pytorch/train.py:315-323`)."""
    return Stack(Rescale(int(image_size * 256 / 224)), RandomCrop(image_size),
                 flip=RandomHorizontalFlip(),
                 jitter=ColorJitter(brightness=0.2, contrast=0.2,
                                    saturation=0.2),
                 normalize=Normalize())


def eval_transform(image_size: int = 224) -> Stack:
    """Rescale(256) → CenterCrop(224) → float → normalize."""
    return Stack(Rescale(int(image_size * 256 / 224)), CenterCrop(image_size),
                 normalize=Normalize())


def host_decode_train_transform(image_size: int = 224) -> Stack:
    """The host half of `--device-augment`: an exact resize to the padded
    square, uint8 (the crop, flip, jitter and normalize run in the
    step's augment)."""
    d = decode_image_size(image_size)
    return Stack(Rescale((d, d)), CenterCrop(d))


def host_decode_eval_transform(image_size: int = 224) -> Stack:
    """The eval half: aspect resize and the central padded square,
    uint8."""
    d = decode_image_size(image_size)
    return Stack(Rescale(d), CenterCrop(d))
