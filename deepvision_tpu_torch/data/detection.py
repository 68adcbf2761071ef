"""Detection input (own copy of deepvision_tpu/data/detection.py:30-182):
the VOC/COCO TFRecords the reference's converters write
(`Datasets/VOC2007/tfrecords.py`, `Datasets/MSCOCO/tfrecords.py`), and
`synthetic_batches`.

Batches: images (B, H, W, 3) f32 in [-1, 1] (uint8 under
`--device-normalize`), boxes (B, MAX_BOXES, 4) normalized corners, classes
(B, MAX_BOXES) int32, valid (B, MAX_BOXES) 0/1 f32, and with
`with_difficult` the VOC difficult flags (B, MAX_BOXES) f32. The record
pipeline yields tensors on its device (decoded by nvJPEG and resampled
with TensorFlow's half-pixel bilinear on the card; PIL and the plain
resample on the CPU); the synthetic one numpy arrays, as the JAX package
yields them. A rank of a data-parallel run makes only its own rows, from
its own stream (data/synthetic.py::rank_stream) or its own files.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence, Tuple

import numpy as np

from ..ops.yolo import MAX_BOXES
from . import records
from .jpeg import decode_resample, extract_jpeg_shape
from .pipeline import RecordPipeline
from .synthetic import rank_stream
from .util import UINT8, Plan, unit_range

f32 = np.float32


class Example(NamedTuple):
    encoded: bytes
    shape: Tuple[int, int]
    boxes: np.ndarray        # (n, 4) xmin, ymin, xmax, ymax, normalized
    classes: np.ndarray      # (n,) int32
    difficult: np.ndarray    # (n,) f32


def parse_example(serialized: bytes) -> Example:
    """The reference schema (`YOLO/tensorflow/preprocess.py:271-285`) plus
    `image/object/difficult` (absent in older records: all easy)."""
    ex = records.parse_example(serialized)
    (encoded,) = records.feature_values(ex, "image/encoded", "bytes")[:1]
    classes = records.feature_values(ex, "image/object/class/label",
                                     "int64").astype(np.int32)
    boxes = np.stack([records.feature_values(ex, f"image/object/bbox/{k}",
                                             "float")
                      for k in ("xmin", "ymin", "xmax", "ymax")],
                     axis=1).astype(f32).reshape(-1, 4)
    difficult = records.feature_values(ex, "image/object/difficult",
                                       "int64").astype(f32)
    if difficult.size == 0:
        difficult = np.zeros(classes.shape, f32)
    return Example(encoded, extract_jpeg_shape(encoded)[:2], boxes, classes,
                   difficult)


def random_flip(boxes: np.ndarray, rng: np.random.Generator
                ) -> Tuple[bool, np.ndarray]:
    """50% horizontal flip, mirroring xmin/xmax (`preprocess.py:37-50`)."""
    if rng.random() < 0.5:
        xmin, ymin, xmax, ymax = boxes.T
        return True, np.stack([f32(1) - xmax, ymin, f32(1) - xmin, ymax],
                              axis=-1).astype(f32)
    return False, boxes


def random_crop_keep_boxes(shape: Tuple[int, int], boxes: np.ndarray,
                           rng: np.random.Generator):
    """50% random crop that keeps every box (`preprocess.py:52-119`):
    margins drawn uniformly between the boxes' union and the edges, boxes
    renormalized to the crop. Returns ((y, x, h, w) or None, boxes)."""
    if len(boxes) == 0 or not rng.random() < 0.5:
        return None, boxes
    h, w = f32(shape[0]), f32(shape[1])
    lo = boxes.min(axis=0)
    hi = boxes.max(axis=0)
    xmin_d = f32(rng.uniform(0.0, max(lo[0], f32(1e-6))))
    ymin_d = f32(rng.uniform(0.0, max(lo[1], f32(1e-6))))
    xmax_d = f32(rng.uniform(0.0, max(f32(1) - hi[2], f32(1e-6))))
    ymax_d = f32(rng.uniform(0.0, max(f32(1) - hi[3], f32(1e-6))))
    w_scale = f32(1) - xmin_d - xmax_d
    h_scale = f32(1) - ymin_d - ymax_d
    xmin, ymin, xmax, ymax = boxes.T
    new = np.stack([(xmin - xmin_d) / w_scale, (ymin - ymin_d) / h_scale,
                    (xmax - xmin_d) / w_scale, (ymax - ymin_d) / h_scale],
                   axis=-1).astype(f32)
    off_h, off_w = int(ymin_d * h), int(xmin_d * w)
    tgt_h = min(int(np.ceil(h_scale * h)), shape[0] - off_h)
    tgt_w = min(int(np.ceil(w_scale * w)), shape[1] - off_w)
    return (off_h, off_w, tgt_h, tgt_w), new


def pad_targets(boxes, classes, difficult):
    """Boxes, classes, valid and difficult padded to MAX_BOXES."""
    n = min(len(boxes), MAX_BOXES)
    b = np.zeros((MAX_BOXES, 4), f32)
    c = np.zeros((MAX_BOXES,), np.int32)
    v = np.zeros((MAX_BOXES,), f32)
    d = np.zeros((MAX_BOXES,), f32)
    b[:n], c[:n], v[:n], d[:n] = boxes[:n], classes[:n], 1.0, difficult[:n]
    return b, c, v, d


def plan(ex: Example, image_size: int, training: bool,
         rng: np.random.Generator) -> Tuple[Plan, np.ndarray]:
    """One record's plan and its (augmented) boxes: flip, then the
    box-keeping crop, then the resize to `image_size`."""
    h, w = ex.shape
    boxes, flip, crop = ex.boxes, False, None
    if training:
        flip, boxes = random_flip(boxes, rng)
        crop, boxes = random_crop_keep_boxes(ex.shape, boxes, rng)
    if crop is None:
        crop = (0, 0, h, w)
    elif flip:                    # the crop of the mirrored image
        y, x, ch, cw = crop
        crop = (y, w - x - cw, ch, cw)
    return Plan(crop, (image_size, image_size), flip=flip), boxes


class DetectionRecords(RecordPipeline):
    """`build_dataset`'s pipeline."""

    def __init__(self, file_pattern: str, *, image_size: int,
                 with_difficult: bool, normalize_on_host: bool, **kw):
        super().__init__(file_pattern, **kw)
        self.image_size = image_size
        self.with_difficult = with_difficult
        self.emit = unit_range() if normalize_on_host else UINT8

    def parse(self, serialized: bytes) -> Example:
        return parse_example(serialized)

    def make_batch(self, items: Sequence[Example],
                   rng: np.random.Generator) -> tuple:
        plans, targets = [], []
        for ex in items:
            p, boxes = plan(ex, self.image_size, self.training, rng)
            plans.append(p)
            targets.append(pad_targets(boxes, ex.classes, ex.difficult))
        size = self.image_size
        images = decode_resample([ex.encoded for ex in items], plans,
                                 [ex.shape for ex in items], (size, size),
                                 "bilinear", self.emit, self.device)
        cols = [self.to_device(np.stack(col)) for col in zip(*targets)]
        return (images, *cols[:3]) + ((cols[3],) if self.with_difficult
                                      else ())


def build_dataset(file_pattern: str, *, batch_size: int,
                  image_size: int = 416, training: bool = True,
                  shuffle_buffer: int = 512, num_process: int = 1,
                  process_index: int = 0, seed: int = 0,
                  with_difficult: bool = False, drop_remainder: bool = True,
                  normalize_on_host: bool = True, device="cpu"
                  ) -> DetectionRecords:
    """The per-rank detection pipeline (the JAX `build_dataset`'s
    arguments, `device` added): one pass per epoch, shuffled in training;
    `drop_remainder=False` keeps the ragged last batch for the mAP
    evaluator."""
    return DetectionRecords(
        file_pattern, batch_size=batch_size, image_size=image_size,
        training=training, shuffle_buffer=shuffle_buffer,
        num_process=num_process, process_index=process_index, seed=seed,
        with_difficult=with_difficult, drop_remainder=drop_remainder,
        normalize_on_host=normalize_on_host, device=device)


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
