"""ImageNet TFRecords (own copy of deepvision_tpu/data/imagenet.py:42-189):
the TF-official schema (`image/encoded`, `image/class/label` 1-indexed)
that `Datasets/ILSVRC2012/build_imagenet_tfrecord.py` writes.

Read by `data/records.py`, decoded by `data/jpeg.py` (nvJPEG on the card,
PIL on the CPU) and resampled with TensorFlow's bicubic
(`data/util.py`), so on the card the whole chain after the read runs on
the device and batches come out as CUDA tensors:
- training: `distorted_crop` (`sample_distorted_bounding_box`'s contract,
  drawn from the port's generator), bicubic to `image_size`, a 50% flip;
- eval: `central_crop`, the aspect-preserving resize to
  `round(image_size / 0.875)` on the short side and the central
  `image_size` square, in JAX's batch order;
- out: f32 normalised on the host side of the contract (clip, /255,
  (x - mean) / std), uint8 for `--device-normalize`, or under
  `host_decode_only` (`--device-augment`) uint8 at the padded decode
  size: the whole image resized to the square in training, the central
  crop at fraction 1.0 in eval. Labels int32 in [0, 1000).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import IMAGENET_MEAN, IMAGENET_STD, decode_image_size
from . import records
from .jpeg import decode_resample, extract_jpeg_shape
from .pipeline import RecordPipeline, epoch_iterator
from .util import UINT8, Plan, normalized

MEAN_RGB = np.array(IMAGENET_MEAN, np.float32)
STDDEV_RGB = np.array(IMAGENET_STD, np.float32)

CROP_FRACTION = 0.875  # eval: 224/256 central crop

#: sample_distorted_bounding_box's arguments (imagenet.py:59-62)
MIN_OBJECT_COVERED = 0.1
ASPECT_RANGE = (3 / 4, 4 / 3)
AREA_RANGE = (0.08, 1.0)
MAX_ATTEMPTS = 10

__all__ = ["parse_example", "distorted_crop", "central_crop", "plan",
           "build_dataset", "epoch_iterator", "ImageNetRecords"]


def parse_example(serialized: bytes) -> Tuple[bytes, int]:
    """(encoded JPEG, label - 1): the label defaults to -1 as
    `FixedLenFeature(default_value=-1)` does."""
    ex = records.parse_example(serialized)
    encoded = records.feature_values(ex, "image/encoded", "bytes")
    if not encoded:
        raise ValueError("an ImageNet record without image/encoded")
    label = records.feature_values(ex, "image/class/label", "int64",
                                   default=np.array([-1], np.int64))
    return encoded[0], int(label[0]) - 1


def distorted_crop(shape: Tuple[int, int], rng: np.random.Generator
                   ) -> Tuple[int, int, int, int]:
    """(y, x, h, w) of a random crop with `sample_distorted_bounding_box`'s
    contract over the whole image: area in AREA_RANGE of the image (and at
    least MIN_OBJECT_COVERED of it), aspect w/h in ASPECT_RANGE, up to
    MAX_ATTEMPTS draws, then the whole image."""
    h, w = shape
    area = float(h * w)
    for _ in range(MAX_ATTEMPTS):
        target = rng.uniform(*AREA_RANGE) * area
        aspect = rng.uniform(*ASPECT_RANGE)
        ch = int(round(math.sqrt(target / aspect)))
        cw = int(round(math.sqrt(target * aspect)))
        if not (1 <= ch <= h and 1 <= cw <= w):
            continue
        frac = ch * cw / area
        if not (max(AREA_RANGE[0], MIN_OBJECT_COVERED) <= frac
                <= AREA_RANGE[1]):
            continue
        if not ASPECT_RANGE[0] <= cw / ch <= ASPECT_RANGE[1]:
            continue
        y = int(rng.integers(0, h - ch + 1))
        x = int(rng.integers(0, w - cw + 1))
        return y, x, ch, cw
    return 0, 0, h, w


def central_crop(shape: Tuple[int, int], image_size: int,
                 crop_fraction: float = CROP_FRACTION) -> Plan:
    """The eval plan (imagenet.py:72-89): the short side resized to
    `round(image_size / crop_fraction)` (half to even, in float32 as
    TensorFlow computes it), the central `image_size` square."""
    h, w = shape
    f32 = np.float32
    padded = int(np.rint(f32(image_size / crop_fraction)))
    scale = f32(padded) / f32(min(h, w))
    new_h = int(np.rint(f32(h) * scale))
    new_w = int(np.rint(f32(w) * scale))
    return Plan((0, 0, h, w), (new_h, new_w),
                ((new_h - image_size) // 2, (new_w - image_size) // 2))


def plan(shape: Tuple[int, int], image_size: int, training: bool,
         rng: Optional[np.random.Generator],
         host_decode_only: bool = False) -> Plan:
    """One record's plan (`preprocess`'s geometry; `image_size` is the
    decode size under `host_decode_only`)."""
    h, w = shape
    if host_decode_only:
        if training:
            return Plan((0, 0, h, w), (image_size, image_size))
        return central_crop(shape, image_size, crop_fraction=1.0)
    if training:
        crop = distorted_crop(shape, rng)
        return Plan(crop, (image_size, image_size),
                    flip=bool(rng.random() < 0.5))
    return central_crop(shape, image_size)


class ImageNetRecords(RecordPipeline):
    """`build_dataset`'s pipeline: batches of (images, labels) on the
    device."""

    cycle_length = 16

    def __init__(self, file_pattern: str, *, image_size: int,
                 normalize_on_host: bool, host_decode_only: bool,
                 mean=None, std=None, **kw):
        super().__init__(file_pattern, **kw)
        self.host_decode_only = host_decode_only
        self.image_size = (decode_image_size(image_size) if host_decode_only
                           else image_size)
        if host_decode_only or not normalize_on_host:
            self.emit = UINT8
        else:
            self.emit = normalized(MEAN_RGB if mean is None else mean,
                                   STDDEV_RGB if std is None else std)

    def parse(self, serialized: bytes):
        encoded, label = parse_example(serialized)
        return encoded, label, extract_jpeg_shape(encoded)[:2]

    def make_batch(self, items: Sequence, rng: np.random.Generator) -> tuple:
        datas = [it[0] for it in items]
        shapes = [it[2] for it in items]
        plans = [plan(s, self.image_size, self.training, rng,
                      self.host_decode_only) for s in shapes]
        size = self.image_size
        images = decode_resample(datas, plans, shapes, (size, size),
                                 "bicubic", self.emit, self.device)
        labels = self.to_device([it[1] for it in items], torch.int32)
        return images, labels


def build_dataset(file_pattern: str, *, batch_size: int,
                  image_size: int = 224, training: bool = True,
                  shuffle_buffer: int = 10000, num_process: int = 1,
                  process_index: int = 0, seed: int = 0,
                  normalize_on_host: bool = True, mean=None, std=None,
                  host_decode_only: bool = False, cache: bool = False,
                  device="cpu") -> ImageNetRecords:
    """The per-rank pipeline over sharded TFRecords (the JAX
    `build_dataset`'s arguments, `device` added). `batch_size` is the
    rank's batch; training shuffles and repeats; eval is JAX's order, its
    records kept in host RAM after the first pass under `cache`;
    `drop_remainder` in both."""
    return ImageNetRecords(
        file_pattern, batch_size=batch_size, image_size=image_size,
        training=training, shuffle_buffer=shuffle_buffer,
        num_process=num_process, process_index=process_index, seed=seed,
        normalize_on_host=normalize_on_host, mean=mean, std=std,
        host_decode_only=host_decode_only, drop_remainder=True,
        repeat=True, cache=cache, device=device)
