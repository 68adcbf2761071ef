"""Device-side batched augmentation of uint8 NHWC batches (own copy of
deepvision_tpu/data/device_augment.py: `channel_stats`, `DEFAULT_JITTER`,
`make_train_augment`, `make_eval_augment`, and the paired stages of dense
prediction, `make_paired_train_augment` and `make_paired_eval_augment`).

The host only decodes and resizes to a padded square
(`core.config.decode_image_size`: 224 -> 256) and ships uint8, a quarter
of the bytes of f32 pixels; crop, flip, ColorJitter and normalization run
on the device inside the train step:

  train: a random SxS crop of the DxD image per example, a horizontal flip
         per example, brightness -> contrast -> saturation factors per
         example (the host ColorJitter's order and ranges), clip to
         [0, 255], (x/255 - mean)/std in f32, one cast to the compute dtype;
  eval:  the centred SxS crop, then the same normalization.

The paired stages (segmentation) take a (B, D, D) mask beside the images:
one crop and flip draw serves both, the mask gets no jitter and no
normalization and comes back int32 (B, S, S).

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


def _crop_flip_index(draws: TrainDraws, image_size: int, device):
    """(batch, rows, cols) index grids of the crops and flips of `draws`:
    a flipped example reads its crop's columns backwards."""
    steps = torch.arange(image_size, device=device)
    rows = draws.tops[:, None] + steps                       # (B, S)
    cols = torch.where(draws.flip[:, None],
                       draws.lefts[:, None] + (image_size - 1) - steps,
                       draws.lefts[:, None] + steps)          # (B, S)
    batch = torch.arange(len(rows), device=device)[:, None, None]
    return batch, rows[:, :, None], cols[:, None, :]


def apply_train_augment(images: torch.Tensor, draws: TrainDraws,
                        image_size: int, *,
                        mean: Sequence[float] = IMAGENET_MEAN,
                        std: Sequence[float] = IMAGENET_STD,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """The train augment of (B, D, D, C) uint8 `images` with `draws`: the
    crop and flip as one gather on index grids, the jitter in f32, clip,
    normalize, cast."""
    b = images.shape[0]
    imgs = images[_crop_flip_index(draws, image_size, images.device)].float()
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


def apply_paired_train_augment(images: torch.Tensor, masks: torch.Tensor,
                               draws: TrainDraws, image_size: int, *,
                               mean: Sequence[float] = IMAGENET_MEAN,
                               std: Sequence[float] = IMAGENET_STD,
                               compute_dtype: torch.dtype = torch.bfloat16):
    """(images, masks) of `apply_train_augment` on the images and the same
    crops and flips on the (B, D, D) masks, returned int32 (B, S, S)."""
    index = _crop_flip_index(draws, image_size, masks.device)
    return (apply_train_augment(images, draws, image_size, mean=mean,
                                std=std, compute_dtype=compute_dtype),
            masks[index].to(torch.int32))


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


def make_paired_train_augment(image_size: int, *,
                              mean: Sequence[float] = IMAGENET_MEAN,
                              std: Sequence[float] = IMAGENET_STD,
                              jitter: Tuple[float, float, float] =
                              DEFAULT_JITTER,
                              flip_prob: float = 0.5,
                              compute_dtype: torch.dtype = torch.bfloat16
                              ) -> Callable:
    """`augment(images_u8, masks_u8, generator) -> (images, masks)`: one
    draw of crops and flips on the generator's device for both, then
    `apply_paired_train_augment`."""

    def augment(images: torch.Tensor, masks: torch.Tensor,
                generator: torch.Generator):
        b, h, w = images.shape[:3]
        draws = draw_train_params(b, h, w, image_size, generator,
                                  jitter=jitter, flip_prob=flip_prob)
        return apply_paired_train_augment(images, masks, draws, image_size,
                                          mean=mean, std=std,
                                          compute_dtype=compute_dtype)

    return augment


def make_paired_eval_augment(image_size: int, *,
                             mean: Sequence[float] = IMAGENET_MEAN,
                             std: Sequence[float] = IMAGENET_STD,
                             compute_dtype: torch.dtype = torch.bfloat16
                             ) -> Callable:
    """`augment(images_u8, masks_u8) -> (images, masks)`: the centred crop
    of both, the images normalized, the masks int32."""
    image_augment = make_eval_augment(image_size, mean=mean, std=std,
                                      compute_dtype=compute_dtype)

    def augment(images: torch.Tensor, masks: torch.Tensor):
        h, w = masks.shape[1:3]
        top, left = (h - image_size) // 2, (w - image_size) // 2
        return (image_augment(images),
                masks[:, top:top + image_size,
                      left:left + image_size].to(torch.int32))

    return augment
