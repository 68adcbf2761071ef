"""GAN input pipelines (own copy of deepvision_tpu/data/gan.py): MNIST in
[-1, 1] for DCGAN (`DCGAN/tensorflow/main.py:21-26`), and the synthetic
batches of both GANs (numpy `RandomState`: the JAX package's batches bit
for bit). CycleGAN's two-domain TFRecords are not ported yet: they read
through TensorFlow, which the port does not depend on.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from .mnist import read_idx_images


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


def build_two_domain_dataset(tfrecord_a: str, tfrecord_b: str, **kwargs):
    """CycleGAN's zipped two-domain TFRecord pipeline: not ported yet."""
    raise NotImplementedError(
        "the CycleGAN two-domain TFRecord pipeline is not ported yet: it "
        "reads TFRecords through TensorFlow, which the port does not "
        "depend on; train with --synthetic")


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
