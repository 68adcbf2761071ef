"""Pose input (own copy of deepvision_tpu/data/pose.py: `NUM_JOINTS` and
`synthetic_batches`). The MPII TFRecord pipeline is not ported: it reads
TFRecords through TensorFlow, which the port does not depend on.

Batches are numpy arrays, as the JAX package yields them: images (B, S,
S, 3) f32 in [-1, 1], kp_x and kp_y (B, 16) normalized keypoints (< 0:
missing), visibility (B, 16) in {0, 2}. The train step renders the
heatmaps on the device (ops/heatmap.py).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from .synthetic import rank_stream

NUM_JOINTS = 16  # MPII


def synthetic_batches(*, batch_size: int, image_size: int = 64,
                      num_joints: int = NUM_JOINTS, steps: int = 2,
                      seed: int = 0, rank: int = 0
                      ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Random keypoint batches of `batch_size` rows from
    `np.random.RandomState(seed)` in the JAX package's order, so the two
    packages see the same batches bit for bit (rank 0; another rank of a
    data-parallel run draws its own rows from its own stream)."""
    rs = rank_stream(seed, rank)
    for _ in range(steps):
        images = rs.rand(batch_size, image_size, image_size, 3).astype(
            np.float32) * 2.0 - 1.0
        kp_x = rs.uniform(0.1, 0.9, (batch_size, num_joints)).astype(np.float32)
        kp_y = rs.uniform(0.1, 0.9, (batch_size, num_joints)).astype(np.float32)
        vis = (rs.rand(batch_size, num_joints) > 0.2).astype(np.float32) * 2.0
        yield images, kp_x, kp_y, vis
