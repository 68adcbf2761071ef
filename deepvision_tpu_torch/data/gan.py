"""GAN input pipelines (own copy of deepvision_tpu/data/gan.py): MNIST in
[-1, 1] for DCGAN (`DCGAN/tensorflow/main.py:21-26`), CycleGAN's zipped
two-domain TFRecords (`CycleGAN/tensorflow/train.py:74-117`, the
single-feature records of `CycleGAN/tensorflow/tfrecords.py`), and the
synthetic batches of both GANs (numpy `RandomState`: the JAX package's
batches bit for bit).
"""

from __future__ import annotations

import itertools
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from . import records
from .jpeg import decode_resample, extract_jpeg_shape, host_crc32c
from .mnist import read_idx_images
from .pipeline import on_side_stream, side_stream
from .util import Plan, unit_range


def mnist_gan_batches(data_dir: str, batch_size: int, *, seed: int = 0,
                      drop_remainder: bool = True) -> Iterator[np.ndarray]:
    """(B, 28, 28, 1) float32 in [-1, 1], shuffled by `seed`."""
    for name in ("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"):
        path = os.path.join(data_dir, name)
        if os.path.exists(path):
            break
    images = read_idx_images(path).astype(np.float32)
    images = (images - 127.5) / 127.5
    images = images[..., None]
    rs = np.random.RandomState(seed)
    order = rs.permutation(len(images))
    for i in range(0, len(order) - (batch_size - 1 if drop_remainder else 0),
                   batch_size):
        yield images[order[i:i + batch_size]]


def synthetic_mnist_batches(batch_size: int, steps: int = 2,
                            seed: int = 0) -> Iterator[np.ndarray]:
    rs = np.random.RandomState(seed)
    for _ in range(steps):
        yield rs.uniform(-1, 1, (batch_size, 28, 28, 1)).astype(np.float32)


def cyclegan_plan(shape: Tuple[int, int], image_size: int, training: bool,
                  rng: Optional[np.random.Generator]) -> Plan:
    """One image's plan (`_parse_cyclegan`): in training a 50% flip, the
    resize to `image_size * 286 / 256` and a random `image_size` crop;
    in eval the resize to `image_size`."""
    h, w = shape
    if not training:
        return Plan((0, 0, h, w), (image_size, image_size))
    flip = bool(rng.random() < 0.5)
    resize = int(image_size * 286 / 256)
    oy = int(rng.integers(0, resize - image_size + 1))
    ox = int(rng.integers(0, resize - image_size + 1))
    return Plan((0, 0, h, w), (resize, resize), (oy, ox), flip)


class TwoDomainRecords:
    """`build_two_domain_dataset`'s pipeline: (image_a, image_b) batches
    on the device, f32 in [-1, 1]."""

    def __init__(self, tfrecord_a: str, tfrecord_b: str, *, batch_size: int,
                 image_size: int, training: bool, shuffle_buffer: int,
                 seed: int, device):
        self.paths = (tfrecord_a, tfrecord_b)
        for p in self.paths:
            if "://" in p:
                raise ValueError(f"remote file systems are not ported "
                                 f"({p!r})")
            if not os.path.exists(p):
                raise FileNotFoundError(f"no such TFRecord file: {p!r}")
        self.batch_size = batch_size
        self.image_size = image_size
        self.training = training
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.device = torch.device(device)
        self._crc = host_crc32c(self.device)
        self._stream = side_stream(self.device)
        self.epoch = 0

    def num_batches(self) -> int:
        """Full batches per epoch: the shorter domain's records over the
        batch (counted without decoding)."""
        n = min(sum(1 for _ in records.read_records(p, check_data=False))
                for p in self.paths)
        return n // self.batch_size

    def _encoded(self, path: str) -> Iterator[bytes]:
        for rec in records.read_records(path, crc=self._crc):
            ex = records.parse_example(rec)
            (enc,) = records.feature_values(ex, "image/encoded", "bytes")[:1]
            yield enc

    def _domain(self, datas, rng) -> torch.Tensor:
        shapes = [extract_jpeg_shape(d)[:2] for d in datas]
        plans = [cyclegan_plan(s, self.image_size, self.training, rng)
                 for s in shapes]
        size = self.image_size
        return decode_resample(datas, plans, shapes, (size, size),
                               "bilinear", unit_range(), self.device)

    def _batch(self, pairs, rng) -> Tuple[torch.Tensor, torch.Tensor]:
        # the flips and crops of domain A, then B (each its own map)
        return (self._domain([p[0] for p in pairs], rng),
                self._domain([p[1] for p in pairs], rng))

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        rng = np.random.default_rng([self.seed, self.epoch])
        self.epoch += 1
        pairs = zip(self._encoded(self.paths[0]),
                    self._encoded(self.paths[1]))
        if self.training:
            pairs = records.shuffle_buffer(pairs, self.shuffle_buffer, rng)
        pairs = iter(pairs)
        while True:
            chunk = list(itertools.islice(pairs, self.batch_size))
            if len(chunk) < self.batch_size:   # drop_remainder
                return
            yield on_side_stream(self._stream, self.device,
                                 lambda: self._batch(chunk, rng))


def build_two_domain_dataset(tfrecord_a: str, tfrecord_b: str, *,
                             batch_size: int, image_size: int = 256,
                             training: bool = True,
                             shuffle_buffer: int = 10000, seed: int = 0,
                             device="cpu") -> TwoDomainRecords:
    """Zipped (image_a, image_b) batches (`CycleGAN/tensorflow/train.py:
    114-117`): the two files read in step, shuffled in training,
    `drop_remainder`; decoded and resampled on `device`."""
    return TwoDomainRecords(tfrecord_a, tfrecord_b, batch_size=batch_size,
                            image_size=image_size, training=training,
                            shuffle_buffer=shuffle_buffer, seed=seed,
                            device=device)


def synthetic_two_domain_batches(batch_size: int, image_size: int = 64,
                                 steps: int = 2, seed: int = 0
                                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Uniform [-1, 1] (a, b) image pairs (the reference's local-testing
    harness, `CycleGAN/tensorflow/train.py:338-342`)."""
    rs = np.random.RandomState(seed)
    for _ in range(steps):
        a = rs.uniform(-1, 1, (batch_size, image_size, image_size, 3))
        b = rs.uniform(-1, 1, (batch_size, image_size, image_size, 3))
        yield a.astype(np.float32), b.astype(np.float32)
