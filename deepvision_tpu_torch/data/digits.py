"""Handwritten digits from scikit-learn's bundled UCI set, the offline
real-data set of LeNet-5 (own copy of the classification half of
deepvision_tpu/data/digits.py: `load_raw`, `_upsample`, `load_splits`, and
the detection scenes `detection_scenes`, `scan_splits`, `detection_splits`,
`detection_val_scenes` and `detection_batches`).

1797 real 8x8 grayscale scans, upsampled to 32 px by pixel replication so
the unchanged `lenet5` model and trainer run MNIST's path; a fixed seeded
80/20 split, normalized by the train split's own mean and std.
scikit-learn is imported when the data is loaded, not with this module.

The detection scenes (the `digits_detect` dataset of `yolov3_digits`)
compose the same real scans into 64 px (or `canvas` px) scenes: 1-4 digits
per scene, one per quadrant, jittered inside it, so ground-truth boxes
never overlap. Train scenes use only train-split scans and val scenes only
the 360 held-out ones; the validation set is pinned at seed 2. For the
same seeds the scenes equal the JAX package's bit for bit.
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


DETECT_MAX_BOXES = 100  # ops/yolo.py MAX_BOXES pad (import cycle avoided)


def detection_scenes(images: np.ndarray, labels: np.ndarray, *,
                     n_scenes: int, canvas: int = 64, digit_px: int = 16,
                     seed: int = 0) -> Tuple[np.ndarray, ...]:
    """Compose scans (N, 8, 8) in [0,1] + labels into detection batches.

    Returns (scenes, boxes, classes, valid) in the padded-GT layout every
    detection trainer consumes (`data/detection.py::synthetic_batches`):
    scenes (S, canvas, canvas, 3) float32 in [-1, 1], boxes normalized
    x1y1x2y2. Quadrant placement: up to 4 digits per scene, one per
    canvas/2-quadrant, jittered inside it — boxes can touch but never
    overlap, so mAP on these scenes measures detection, not tie-breaking.
    """
    if digit_px % 8 != 0:
        raise ValueError(f"digit_px={digit_px} must be a multiple of the "
                         f"8px scan size (pixel-replication upsample) — a "
                         f"non-multiple would render 8*(digit_px//8) pixels "
                         f"under a digit_px-sized GT box")
    rs = np.random.RandomState(seed)
    q = canvas // 2
    jitter = q - digit_px
    scale = digit_px // 8
    scenes = np.zeros((n_scenes, canvas, canvas, 3), np.float32)
    boxes = np.zeros((n_scenes, DETECT_MAX_BOXES, 4), np.float32)
    classes = np.zeros((n_scenes, DETECT_MAX_BOXES), np.int32)
    valid = np.zeros((n_scenes, DETECT_MAX_BOXES), np.float32)
    for s in range(n_scenes):
        n_digits = rs.randint(1, 5)
        quads = rs.permutation(4)[:n_digits]
        for slot, quad in enumerate(quads):
            i = rs.randint(len(images))
            digit = images[i].repeat(scale, axis=0).repeat(scale, axis=1)
            qy, qx = divmod(int(quad), 2)
            y0 = qy * q + rs.randint(0, jitter + 1)
            x0 = qx * q + rs.randint(0, jitter + 1)
            scenes[s, y0:y0 + digit_px, x0:x0 + digit_px, :] = digit[..., None]
            boxes[s, slot] = (x0 / canvas, y0 / canvas,
                              (x0 + digit_px) / canvas,
                              (y0 + digit_px) / canvas)
            classes[s, slot] = labels[i]
            valid[s, slot] = 1.0
    return scenes * 2.0 - 1.0, boxes, classes, valid


def scan_splits() -> Tuple[Tuple[np.ndarray, np.ndarray],
                           Tuple[np.ndarray, np.ndarray]]:
    """The raw 8x8 scans under the SAME seeded split as the classification
    gate: (train scans, labels), (held-out scans, labels)."""
    images, labels = load_raw(image_size=8)
    images = images[..., 0]
    order = np.random.RandomState(SPLIT_SEED).permutation(len(labels))
    images, labels = images[order], labels[order]
    return ((images[:TRAIN_EXAMPLES], labels[:TRAIN_EXAMPLES]),
            (images[TRAIN_EXAMPLES:], labels[TRAIN_EXAMPLES:]))


def detection_splits(*, canvas: int = 64, digit_px: int = 16,
                     train_scenes: int = 512, val_scenes: int = 128,
                     train_seed: int = 1):
    """Deterministic (train, val) detection-scene sets: train scenes compose
    only train-split scans, val scenes only the held-out 360 — so val
    measures generalization to unseen handwriting, not re-detection of seen
    crops. `train_seed` lets the trainer re-compose FRESH train scenes each
    epoch (composition is free; scene diversity is the real regularizer) —
    the val set stays pinned at seed 2."""
    (tr_x, tr_y), (va_x, va_y) = scan_splits()
    tr = detection_scenes(tr_x, tr_y, n_scenes=train_scenes, canvas=canvas,
                          digit_px=digit_px, seed=train_seed)
    va = detection_scenes(va_x, va_y, n_scenes=val_scenes, canvas=canvas,
                          digit_px=digit_px, seed=2)
    return tr, va


def detection_val_scenes(*, canvas: int, n_scenes: int):
    """THE pinned validation scene set (seed 2, held-out scans only) — the
    single owner of the identity that training validates against and the
    evaluator scores (cli.py's digits_detect and YOLO/torch/evaluate.py),
    the JAX package's set bit for bit. Change it here or nowhere."""
    _, (va_x, va_y) = scan_splits()
    return detection_scenes(va_x, va_y, n_scenes=n_scenes, canvas=canvas,
                            seed=2)


def detection_batches(split: Tuple[np.ndarray, ...], *, batch_size: int,
                      shuffle_seed: int = None):
    """Iterate a detection-scene split in batches (drop-remainder, the
    detection trainers' fixed-shape contract)."""
    scenes, boxes, classes, valid = split
    idx = np.arange(len(scenes))
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed).shuffle(idx)
    for lo in range(0, len(idx) - batch_size + 1, batch_size):
        sel = idx[lo:lo + batch_size]
        yield scenes[sel], boxes[sel], classes[sel], valid[sel]
