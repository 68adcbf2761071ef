"""Segmentation datasets (own copy of deepvision_tpu/data/segmentation.py:
`class_palette`, `SyntheticSegmentation`, `segmentation_scenes`,
`segmentation_val_scenes`, `segmentation_batches`).

- `SyntheticSegmentation`: deterministic in-memory (image, mask) batches
  with a learnable signal (each class has its own palette colour), float
  [-1, 1] images and int32 masks at the model's size, or with
  `emit_uint8` raw uint8 images and uint8 masks at the padded decode size
  (the staging contract of the paired device augment,
  data/device_augment.py).
- digit scenes: real scikit-learn digit scans composed onto a canvas as
  the detection scenes are (data/digits.py), with dense ground truth:
  class digit + 1 on the pasted digit's foreground pixels, 0 elsewhere
  (11 classes). Train scenes use train-split scans only, the pinned
  validation set (seed 2) the held-out ones.

Numpy `RandomState` code throughout: for the same seeds the batches equal
the JAX package's bit for bit. A rank of a data-parallel run makes only
its own rows of the synthetic batches, from a stream of its own
(data/synthetic.py::rank_stream); rank 0's rows are the one-process ones.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from .digits import scan_splits
from .synthetic import rank_stream

# the intensity above which a pasted scan's pixel is the digit's (scans
# are in [0, 1]; strokes sit well above it)
DIGIT_FOREGROUND_THRESH = 0.25


def class_palette(num_classes: int, channels: int = 3) -> np.ndarray:
    """Deterministic (num_classes, channels) float palette in [0.15, 0.85]
    with class 0 (background) dark."""
    rs = np.random.RandomState(20260804)
    pal = 0.15 + 0.7 * rs.rand(max(num_classes, 1), channels)
    pal[0] = 0.1
    return pal.astype(np.float32)


class SyntheticSegmentation:
    """Fake (image, mask) batches: background (class 0) with 1-3 rectangles
    of random foreground classes, each pixel its class's palette colour
    plus Gaussian noise, the mask its class id. `batch_size` is the rows
    this `rank` makes."""

    def __init__(self, batch_size: int, image_size: int = 64,
                 channels: int = 3, num_classes: int = 6,
                 num_batches: int = 8, seed: int = 0,
                 emit_uint8: bool = False, rank: int = 0):
        if num_classes < 2:
            raise ValueError(f"segmentation needs >= 2 classes (background "
                             f"+ 1), got {num_classes}")
        self.batch_size = batch_size
        self.image_size = image_size
        self.channels = channels
        self.num_classes = num_classes
        self.num_batches = num_batches
        self.seed = seed
        self.emit_uint8 = emit_uint8
        self.rank = rank
        self._palette = class_palette(num_classes, channels)

    def _scene(self, rs: np.random.RandomState
               ) -> Tuple[np.ndarray, np.ndarray]:
        s = self.image_size
        mask = np.zeros((s, s), np.int32)
        image = np.broadcast_to(self._palette[0], (s, s, self.channels)).copy()
        for _ in range(rs.randint(1, 4)):
            c = rs.randint(1, self.num_classes)
            h = rs.randint(s // 4, s // 2 + 1)
            w = rs.randint(s // 4, s // 2 + 1)
            y0 = rs.randint(0, s - h + 1)
            x0 = rs.randint(0, s - w + 1)
            mask[y0:y0 + h, x0:x0 + w] = c
            image[y0:y0 + h, x0:x0 + w] = self._palette[c]
        image = image + rs.randn(s, s, self.channels).astype(np.float32) * 0.05
        return np.clip(image, 0.0, 1.0), mask

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rs = rank_stream(self.seed, self.rank)
        for _ in range(self.num_batches):
            images = np.empty((self.batch_size, self.image_size,
                               self.image_size, self.channels), np.float32)
            masks = np.empty((self.batch_size, self.image_size,
                              self.image_size), np.int32)
            for i in range(self.batch_size):
                images[i], masks[i] = self._scene(rs)
            if self.emit_uint8:
                yield (np.round(images * 255.0).astype(np.uint8),
                       masks.astype(np.uint8))
            else:
                yield images * 2.0 - 1.0, masks

    def __len__(self) -> int:
        return self.num_batches


def segmentation_scenes(images: np.ndarray, labels: np.ndarray, *,
                        n_scenes: int, canvas: int = 64, digit_px: int = 16,
                        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Compose raw (N, 8, 8) scans in [0, 1] and their labels into
    (scenes, masks): 1-4 digits a scene, one per quadrant, jittered (they
    may touch, never overlap); mask = label + 1 where the pasted digit's
    own intensity exceeds DIGIT_FOREGROUND_THRESH. Scenes are float32
    [-1, 1] NHWC, masks int32 (n_scenes, canvas, canvas)."""
    if digit_px % 8 != 0:
        raise ValueError(f"digit_px={digit_px} must be a multiple of the 8px "
                         f"scan size (pixel-replication upsample)")
    rs = np.random.RandomState(seed)
    q = canvas // 2
    jitter = q - digit_px
    scale = digit_px // 8
    scenes = np.zeros((n_scenes, canvas, canvas, 3), np.float32)
    masks = np.zeros((n_scenes, canvas, canvas), np.int32)
    for s in range(n_scenes):
        n_digits = rs.randint(1, 5)
        quads = rs.permutation(4)[:n_digits]
        for quad in quads:
            i = rs.randint(len(images))
            digit = images[i].repeat(scale, axis=0).repeat(scale, axis=1)
            qy, qx = divmod(int(quad), 2)
            y0 = qy * q + rs.randint(0, jitter + 1)
            x0 = qx * q + rs.randint(0, jitter + 1)
            scenes[s, y0:y0 + digit_px, x0:x0 + digit_px, :] = digit[..., None]
            fg = digit > DIGIT_FOREGROUND_THRESH
            masks[s, y0:y0 + digit_px, x0:x0 + digit_px][fg] = labels[i] + 1
    return scenes * 2.0 - 1.0, masks


def segmentation_val_scenes(*, canvas: int, n_scenes: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """The pinned validation scenes: seed 2, held-out scans only."""
    _, (va_x, va_y) = scan_splits()
    return segmentation_scenes(va_x, va_y, n_scenes=n_scenes, canvas=canvas,
                               seed=2)


def segmentation_batches(split: Tuple[np.ndarray, np.ndarray], *,
                         batch_size: int, shuffle_seed: Optional[int] = None
                         ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """A (scenes, masks) split in drop-remainder batches, shuffled by
    `shuffle_seed` when given."""
    scenes, masks = split
    idx = np.arange(len(scenes))
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed).shuffle(idx)
    for lo in range(0, len(idx) - batch_size + 1, batch_size):
        sel = idx[lo:lo + batch_size]
        yield scenes[sel], masks[sel]
