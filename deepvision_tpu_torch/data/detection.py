"""Detection input (own copy of deepvision_tpu/data/detection.py:
`synthetic_batches` only). The TFRecord VOC/COCO pipeline is not ported
yet.

Batches are numpy arrays, as the JAX package yields them: images (B, H, W,
3) f32 in [-1, 1], boxes (B, MAX_BOXES, 4) normalized corners, classes
(B, MAX_BOXES) int32, valid (B, MAX_BOXES) 0/1 f32. A rank of a
data-parallel run makes only its own rows, from its own stream
(data/synthetic.py::rank_stream).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..ops.yolo import MAX_BOXES
from .synthetic import rank_stream


def synthetic_batches(*, batch_size: int, image_size: int = 64,
                      num_classes: int = 4, steps: int = 2,
                      num_boxes: int = 3, seed: int = 0, rank: int = 0
                      ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Random but well-formed detection batches of `batch_size` rows,
    drawn from `np.random.RandomState(seed)` in the JAX package's order,
    so the two packages see the same batches bit for bit (rank 0; another
    rank draws from its own stream)."""
    rs = rank_stream(seed, rank)
    for _ in range(steps):
        images = rs.rand(batch_size, image_size, image_size, 3).astype(
            np.float32) * 2.0 - 1.0
        xy1 = rs.uniform(0.0, 0.6, (batch_size, MAX_BOXES, 2))
        wh = rs.uniform(0.05, 0.4, (batch_size, MAX_BOXES, 2))
        boxes = np.concatenate([xy1, np.minimum(xy1 + wh, 1.0)],
                               axis=-1).astype(np.float32)
        classes = rs.randint(0, num_classes,
                             (batch_size, MAX_BOXES)).astype(np.int32)
        valid = np.zeros((batch_size, MAX_BOXES), np.float32)
        valid[:, :num_boxes] = 1.0
        yield images, boxes, classes, valid
