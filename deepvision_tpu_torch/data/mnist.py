"""MNIST idx files and the batch iterator over in-memory arrays (own copy
of deepvision_tpu/data/mnist.py: `read_idx_images`, `read_idx_labels`,
`preprocess`, `load_split`, `MnistBatches`).

Reads the raw idx binaries (or their `.gz`), pads 28x28 to 32x32,
normalizes with MNIST's mean and std (0.1307, 0.3081) and yields NHWC f32
batches. Numpy only.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np

from ..parallel.mesh import shard_rows

MEAN, STD = 0.1307, 0.3081

FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def read_idx_images(path: str) -> np.ndarray:
    """An idx3-ubyte image file (magic 2051) -> (N, rows, cols) uint8."""
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad magic {magic} (want 2051)")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    """An idx1-ubyte label file (magic 2049) -> (N,) uint8."""
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad magic {magic} (want 2049)")
        return np.frombuffer(f.read(n), dtype=np.uint8)


def preprocess(images: np.ndarray) -> np.ndarray:
    """uint8 (N, 28, 28) -> normalized f32 (N, 32, 32, 1), zero-padded 2
    pixels on each side."""
    x = np.pad(images, ((0, 0), (2, 2), (2, 2)),
               mode="constant").astype(np.float32)
    x = (x / 255.0 - MEAN) / STD
    return x[..., None]


def load_split(data_dir: str, split: str) -> Tuple[np.ndarray, np.ndarray]:
    """(preprocessed images, int32 labels) of `split` ("train" or "test")
    from `data_dir`, each idx file raw or gzipped."""
    paths = []
    for name in FILES[split]:
        path = os.path.join(data_dir, name)
        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            path += ".gz"
        paths.append(path)
    images = read_idx_images(paths[0])
    return preprocess(images), read_idx_labels(paths[1]).astype(np.int32)


class MnistBatches:
    """(images, labels) batches of in-memory arrays, shuffled with a seeded
    `RandomState` per iterator; `drop_remainder` drops the last partial
    batch. With `world` > 1, `batch_size` is the global batch and each
    batch is `rank`'s rows [rank·b, (rank + 1)·b) of it (b = batch_size //
    world): the ranks of a data-parallel run see, together, exactly the
    one-process epoch's images."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True, rank: int = 0,
                 world: int = 1):
        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.drop_remainder = drop_remainder

    def __iter__(self):
        idx = np.arange(len(self.labels))
        if self.shuffle:
            self.rng.shuffle(idx)
        end = (len(idx) - len(idx) % self.batch_size if self.drop_remainder
               else len(idx))
        for i in range(0, end, self.batch_size):
            sel = idx[i:i + self.batch_size]
            if self.world > 1:
                sel = shard_rows(sel, self.rank, self.world)
            yield self.images[sel], self.labels[sel]

    def __len__(self):
        n = len(self.labels) // self.batch_size
        return n if self.drop_remainder else -(-len(self.labels)
                                               // self.batch_size)
