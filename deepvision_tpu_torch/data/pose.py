"""Pose input (own copy of deepvision_tpu/data/pose.py:33-147): the MPII
TFRecords of `Datasets/MPII/tfrecords_mpii.py` (parts/x and parts/y
normalized by the image size, < 0 for a missing joint; parts/v in {0, 2}),
cropped to the keypoints' box plus a margin (U(0.1, 0.3) in training, 0.2
in eval; no crop for a record without any joint), and `synthetic_batches`.

Batches: images (B, S, S, 3) f32 in [-1, 1] (uint8 under
`--device-normalize`), kp_x and kp_y (B, 16) normalized to the crop (< 0:
missing), visibility (B, 16), each padded to 16 with -1. The record
pipeline yields tensors on its device (nvJPEG and TensorFlow's half-pixel
bilinear on the card; PIL and the plain resample on the CPU), the
synthetic one numpy arrays. The train step renders the heatmaps on the
device (ops/heatmap.py).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence, Tuple

import numpy as np

from . import records
from .jpeg import decode_resample, extract_jpeg_shape
from .pipeline import RecordPipeline
from .synthetic import rank_stream
from .util import UINT8, Plan, unit_range

NUM_JOINTS = 16  # MPII
f32 = np.float32


class Example(NamedTuple):
    encoded: bytes
    shape: Tuple[int, int]
    kp_x: np.ndarray
    kp_y: np.ndarray
    vis: np.ndarray


def parse_example(serialized: bytes) -> Example:
    ex = records.parse_example(serialized)
    (encoded,) = records.feature_values(ex, "image/encoded", "bytes")[:1]
    return Example(encoded, extract_jpeg_shape(encoded)[:2],
                   records.feature_values(ex, "image/object/parts/x",
                                          "float"),
                   records.feature_values(ex, "image/object/parts/y",
                                          "float"),
                   records.feature_values(ex, "image/object/parts/v",
                                          "int64").astype(f32))


def crop_roi(shape: Tuple[int, int], kp_x: np.ndarray, kp_y: np.ndarray,
             margin: float):
    """The crop (y, x, h, w) of the visible keypoints' box plus `margin`
    of its extent, and the keypoints renormalized to it
    (`preprocess.py:43-88`), in float32 as TensorFlow computes it."""
    h, w = f32(shape[0]), f32(shape[1])
    ok = (kp_x >= 0) & (kp_y >= 0)
    xmin = np.where(ok, kp_x, f32(2)).min()
    xmax = np.where(ok, kp_x, f32(-1)).max()
    ymin = np.where(ok, kp_y, f32(2)).min()
    ymax = np.where(ok, kp_y, f32(-1)).max()
    extent = max(xmax - xmin, ymax - ymin)
    pad = f32(margin) * max(extent, f32(1e-3))
    exmin = np.clip(xmin - pad, f32(0), f32(1))
    eymin = np.clip(ymin - pad, f32(0), f32(1))
    exmax = np.clip(xmax + pad, f32(0), f32(1))
    eymax = np.clip(ymax + pad, f32(0), f32(1))
    off_y = min(int(eymin * h), shape[0] - 1)
    off_x = min(int(exmin * w), shape[1] - 1)
    tgt_h = min(max(int((eymax - eymin) * h), 1), shape[0] - off_y)
    tgt_w = min(max(int((exmax - exmin) * w), 1), shape[1] - off_x)
    new_w, new_h = exmax - exmin, eymax - eymin
    kx = np.where(ok, (kp_x - exmin) / max(new_w, f32(1e-6)), f32(-1))
    ky = np.where(ok, (kp_y - eymin) / max(new_h, f32(1e-6)), f32(-1))
    return (off_y, off_x, tgt_h, tgt_w), kx.astype(f32), ky.astype(f32)


def fix(t: np.ndarray) -> np.ndarray:
    """The first 16 values, padded with -1."""
    t = np.asarray(t, f32)[:NUM_JOINTS]
    return np.pad(t, (0, NUM_JOINTS - len(t)), constant_values=-1.0)


def plan(ex: Example, image_size: int, training: bool,
         rng: np.random.Generator):
    """One record's plan and its keypoints (kp_x, kp_y, vis)."""
    h, w = ex.shape
    margin = rng.uniform(0.1, 0.3) if training else 0.2
    kp_x, kp_y, crop = ex.kp_x, ex.kp_y, (0, 0, h, w)
    if ((kp_x >= 0) & (kp_y >= 0)).any():
        crop, kp_x, kp_y = crop_roi(ex.shape, kp_x, kp_y, margin)
    return (Plan(crop, (image_size, image_size)),
            (fix(kp_x), fix(kp_y), fix(ex.vis)))


class PoseRecords(RecordPipeline):
    """`build_dataset`'s pipeline."""

    def __init__(self, file_pattern: str, *, image_size: int,
                 normalize_on_host: bool, **kw):
        super().__init__(file_pattern, **kw)
        self.image_size = image_size
        self.emit = unit_range() if normalize_on_host else UINT8

    def parse(self, serialized: bytes) -> Example:
        return parse_example(serialized)

    def make_batch(self, items: Sequence[Example],
                   rng: np.random.Generator) -> tuple:
        plans, joints = zip(*(plan(ex, self.image_size, self.training, rng)
                              for ex in items))
        size = self.image_size
        images = decode_resample([ex.encoded for ex in items], plans,
                                 [ex.shape for ex in items], (size, size),
                                 "bilinear", self.emit, self.device)
        return (images, *(self.to_device(np.stack(col))
                          for col in zip(*joints)))


def build_dataset(file_pattern: str, *, batch_size: int,
                  image_size: int = 256, training: bool = True,
                  shuffle_buffer: int = 512, num_process: int = 1,
                  process_index: int = 0, seed: int = 0,
                  normalize_on_host: bool = True, device="cpu"
                  ) -> PoseRecords:
    """The per-rank pose pipeline (the JAX `build_dataset`'s arguments,
    `device` added): one pass per epoch, shuffled in training,
    `drop_remainder`."""
    return PoseRecords(
        file_pattern, batch_size=batch_size, image_size=image_size,
        training=training, shuffle_buffer=shuffle_buffer,
        num_process=num_process, process_index=process_index, seed=seed,
        normalize_on_host=normalize_on_host, drop_remainder=True,
        device=device)


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
