"""Device-side batched augmentation of uint8 NHWC batches (own copy of
deepvision_tpu/data/device_augment.py: `channel_stats`, `DEFAULT_JITTER`,
`make_train_augment`, `make_eval_augment`).

The host only decodes and resizes to a padded square
(`core.config.decode_image_size`: 224 -> 256) and ships uint8, a quarter
of the bytes of f32 pixels; crop, flip, ColorJitter and normalization run
on the device inside the train step:

  train: a random SxS crop of the DxD image per example, a horizontal flip
         per example, brightness -> contrast -> saturation factors per
         example (the host ColorJitter's order and ranges), clip to
         [0, 255], (x/255 - mean)/std in f32, one cast to the compute dtype;
  eval:  the centred SxS crop, then the same normalization.

The draws are split from the transform: `draw_train_params` draws (tops,
lefts, flip, brightness, contrast, saturation) per example from an
explicit generator, `apply_train_augment` applies given draws. JAX's PRNG
bits cannot be reproduced, so the parity tests feed JAX's own draws to
`apply_train_augment`; the train step draws from the state's per-(seed,
step) generator on its own stream, so runs repeat per (seed, step).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core.config import IMAGENET_MEAN, IMAGENET_STD

# the host train transform's ColorJitter(0.2, 0.2, 0.2)
DEFAULT_JITTER: Tuple[float, float, float] = (0.2, 0.2, 0.2)


def channel_stats(values: Sequence[float], channels: int) -> Tuple[float, ...]:
    """Length-C normalization statistics for a C-channel input: as they
    are on a match, else their mean repeated C times (the grayscale
    MNIST-family configs carry the 3-channel ImageNet statistics)."""
    values = tuple(float(v) for v in values)
    if len(values) == channels:
        return values
    return (sum(values) / len(values),) * channels


@dataclasses.dataclass
class TrainDraws:
    """Per-example draws of the train augment, each of leading size B:
    crop offsets (int64), flips (bool), and the jitter factors (f32), None
    where that jitter is off."""
    tops: torch.Tensor
    lefts: torch.Tensor
    flip: torch.Tensor
    brightness: Optional[torch.Tensor] = None
    contrast: Optional[torch.Tensor] = None
    saturation: Optional[torch.Tensor] = None

    def to(self, device) -> "TrainDraws":
        return TrainDraws(*(None if t is None else t.to(device)
                            for t in vars(self).values()))


def draw_train_params(batch: int, height: int, width: int, image_size: int,
                      generator: torch.Generator, *,
                      jitter: Tuple[float, float, float] = DEFAULT_JITTER,
                      flip_prob: float = 0.5) -> TrainDraws:
    """The train augment's draws on the generator's device, with the JAX
    package's distributions: offsets uniform over
    [0, max(H - S, W - S)] clipped to each axis' range, a flip with
    probability `flip_prob`, and each jitter factor uniform on
    [max(0, 1 - s), 1 + s]."""
    device = generator.device
    offs = torch.randint(0, max(height - image_size, width - image_size) + 1,
                         (2, batch), generator=generator, device=device)
    flip = torch.rand(batch, generator=generator, device=device) < flip_prob

    def factor(strength):
        if not strength:
            return None
        lo, hi = max(0.0, 1.0 - strength), 1.0 + strength
        return lo + (hi - lo) * torch.rand(batch, generator=generator,
                                           device=device)

    return TrainDraws(offs[0].clamp(max=height - image_size),
                      offs[1].clamp(max=width - image_size), flip,
                      *(factor(s) for s in jitter))


def _normalize(images: torch.Tensor, mean, std,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """[0, 255] f32 -> (x/255 - mean)/std, channel-last, then one cast."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=images.device)
    return ((images / 255.0 - mean) / std).to(compute_dtype)


def apply_train_augment(images: torch.Tensor, draws: TrainDraws,
                        image_size: int, *,
                        mean: Sequence[float] = IMAGENET_MEAN,
                        std: Sequence[float] = IMAGENET_STD,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """The train augment of (B, D, D, C) uint8 `images` with `draws`: the
    crop and flip as one gather on index grids (a flipped example reads its
    crop's columns backwards), the jitter in f32, clip, normalize, cast."""
    b = images.shape[0]
    steps = torch.arange(image_size, device=images.device)
    rows = draws.tops[:, None] + steps                       # (B, S)
    cols = torch.where(draws.flip[:, None],
                       draws.lefts[:, None] + (image_size - 1) - steps,
                       draws.lefts[:, None] + steps)          # (B, S)
    batch = torch.arange(b, device=images.device)[:, None, None]
    imgs = images[batch, rows[:, :, None], cols[:, None, :]].float()
    if draws.brightness is not None:
        imgs = imgs * draws.brightness.view(b, 1, 1, 1)
    if draws.contrast is not None:
        m = imgs.mean(dim=(1, 2), keepdim=True)
        imgs = (imgs - m) * draws.contrast.view(b, 1, 1, 1) + m
    if draws.saturation is not None:
        gray = imgs.mean(dim=3, keepdim=True)
        imgs = (imgs - gray) * draws.saturation.view(b, 1, 1, 1) + gray
    imgs = imgs.clamp(0.0, 255.0)
    return _normalize(imgs, mean, std, compute_dtype)


def make_train_augment(image_size: int, *,
                       mean: Sequence[float] = IMAGENET_MEAN,
                       std: Sequence[float] = IMAGENET_STD,
                       jitter: Tuple[float, float, float] = DEFAULT_JITTER,
                       flip_prob: float = 0.5,
                       compute_dtype: torch.dtype = torch.bfloat16
                       ) -> Callable[[torch.Tensor, torch.Generator],
                                     torch.Tensor]:
    """`augment(images_u8, generator) -> images`: draws on the generator's
    device, then `apply_train_augment`. `images_u8` is (B, D, D, C) with
    D >= image_size; D == image_size is the identity crop."""

    def augment(images: torch.Tensor, generator: torch.Generator):
        b, h, w = images.shape[:3]
        draws = draw_train_params(b, h, w, image_size, generator,
                                  jitter=jitter, flip_prob=flip_prob)
        return apply_train_augment(images, draws, image_size, mean=mean,
                                   std=std, compute_dtype=compute_dtype)

    return augment


def make_eval_augment(image_size: int, *,
                      mean: Sequence[float] = IMAGENET_MEAN,
                      std: Sequence[float] = IMAGENET_STD,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """`augment(images_u8) -> images`: the centred crop and normalization,
    no draws."""

    def augment(images: torch.Tensor):
        h, w = images.shape[1:3]
        top, left = (h - image_size) // 2, (w - image_size) // 2
        crop = images[:, top:top + image_size, left:left + image_size, :]
        return _normalize(crop.float(), mean, std, compute_dtype)

    return augment
