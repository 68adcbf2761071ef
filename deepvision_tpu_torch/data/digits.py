"""Handwritten digits from scikit-learn's bundled UCI set, the offline
real-data set of LeNet-5 (own copy of the classification half of
deepvision_tpu/data/digits.py: `load_raw`, `_upsample`, `load_splits`).

1797 real 8x8 grayscale scans, upsampled to 32 px by pixel replication so
the unchanged `lenet5` model and trainer run MNIST's path; a fixed seeded
80/20 split, normalized by the train split's own mean and std.
scikit-learn is imported when the data is loaded, not with this module.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

TRAIN_EXAMPLES = 1437   # 80/20 split of the 1797 scans (seeded, fixed)
VAL_EXAMPLES = 360
SPLIT_SEED = 20260801


def _upsample(images: np.ndarray, factor: int = 4) -> np.ndarray:
    """(N, 8, 8) -> (N, 8 * factor, 8 * factor) by pixel replication."""
    return images.repeat(factor, axis=1).repeat(factor, axis=2)


def load_raw(image_size: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """All 1797 scans as (N, image_size, image_size, 1) f32 in [0, 1] and
    int32 labels."""
    from sklearn.datasets import load_digits
    bunch = load_digits()
    images = bunch.images.astype(np.float32) / 16.0      # pixels 0..16
    labels = bunch.target.astype(np.int32)
    return _upsample(images, image_size // 8)[..., None], labels


def load_splits(image_size: int = 32
                ) -> Tuple[Tuple[np.ndarray, np.ndarray],
                           Tuple[np.ndarray, np.ndarray]]:
    """((train images, labels), (test images, labels)), NHWC f32,
    normalized by the train split's mean and std."""
    images, labels = load_raw(image_size)
    images = images[..., 0]
    order = np.random.RandomState(SPLIT_SEED).permutation(len(labels))
    images, labels = images[order], labels[order]
    tr_x, te_x = images[:TRAIN_EXAMPLES], images[TRAIN_EXAMPLES:]
    tr_y, te_y = labels[:TRAIN_EXAMPLES], labels[TRAIN_EXAMPLES:]
    mean, std = float(tr_x.mean()), float(tr_x.std())
    tr_x = ((tr_x - mean) / std)[..., None]
    te_x = ((te_x - mean) / std)[..., None]
    return (tr_x, tr_y), (te_x, te_y)
