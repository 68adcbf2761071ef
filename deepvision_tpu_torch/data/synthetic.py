"""Synthetic classification batches (own copy of
deepvision_tpu/data/synthetic.py::SyntheticClassification): the same numpy
`RandomState` stream, so a seed gives the JAX package's batches bit for bit.

A rank of a data-parallel run makes only its own rows, from a stream of
its own: `rank` r > 0 draws from `RandomState([seed, r])`, rank 0 from
`RandomState(seed)`, so a one-process run makes exactly the batches it
always made.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def rank_stream(seed: int, rank: int) -> np.random.RandomState:
    """The host stream of `rank`'s rows: rank 0's is `RandomState(seed)`."""
    return np.random.RandomState(seed if rank == 0 else [seed, rank])


class SyntheticClassification:
    """Deterministic (images, labels) batches, NHWC f32 images and int32
    labels, with a learnable signal: the label shifts the image's mean, so
    a model can fit it. `emit_uint8=True` maps the same signal into raw
    [0, 255] uint8 pixels. `batch_size` is the rows this `rank` makes."""

    def __init__(self, batch_size: int, image_size: int = 32, channels: int = 3,
                 num_classes: int = 10, num_batches: int = 8, seed: int = 0,
                 learnable: bool = True, emit_uint8: bool = False,
                 rank: int = 0):
        self.batch_size = batch_size
        self.image_size = image_size
        self.channels = channels
        self.num_classes = num_classes
        self.num_batches = num_batches
        self.seed = seed
        self.learnable = learnable
        self.emit_uint8 = emit_uint8
        self.rank = rank

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = rank_stream(self.seed, self.rank)
        for _ in range(self.num_batches):
            labels = rng.randint(0, self.num_classes, size=(self.batch_size,))
            images = rng.randn(self.batch_size, self.image_size,
                               self.image_size, self.channels
                               ).astype(np.float32)
            if self.learnable:
                images += (labels / self.num_classes
                           - 0.5)[:, None, None, None] * 4.0
            if self.emit_uint8:
                images = np.clip(images * 32.0 + 128.0, 0.0, 255.0)
                images = np.round(images).astype(np.uint8)
            yield images, labels.astype(np.int32)

    def __len__(self) -> int:
        return self.num_batches
