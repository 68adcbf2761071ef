"""Host-side image helpers of the GAN inference scripts
(`DCGAN/torch/inference.py`, `CycleGAN/torch/inference.py`): plain numpy,
so `chip_smoke.py` and the tests call them without PIL."""

from __future__ import annotations

import numpy as np


def to_uint8(images: np.ndarray) -> np.ndarray:
    """[-1, 1] floats -> uint8 [0, 255] (x * 127.5 + 127.5, clipped,
    truncated as the JAX scripts do)."""
    return (np.asarray(images, np.float32) * 127.5 + 127.5).clip(
        0, 255).astype(np.uint8)


def tile_grid(images: np.ndarray) -> np.ndarray:
    """(N, H, W, 1) images in [-1, 1] -> one uint8 (n*H, n*W) grid, n =
    ceil(sqrt(N)), row by row, empty cells 0."""
    images = np.asarray(images)
    num, h, w = images.shape[:3]
    n = int(np.ceil(np.sqrt(num)))
    grid = np.zeros((n * h, n * w), np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, n)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = to_uint8(img[..., 0])
    return grid


def side_by_side(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """An (H, W, 3) input and its translation in [-1, 1] -> one uint8
    (H, 2W, 3) image, input | output."""
    return to_uint8(np.concatenate([src, dst], axis=1))


def load_pil():
    """PIL's Image module, or a named error: the inference scripts write
    PNGs through it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the GAN inference scripts read and write images "
                          "with Pillow (PIL), which is not installed") from e
    return Image
