"""Host-side history of generated images for the CycleGAN discriminator
(own copy of deepvision_tpu/utils/image_pool.py; the reference's
`CycleGAN/tensorflow/utils.py:31-61`): while the pool fills, images pass
through; once full, each incoming image is swapped with a random stored
one with probability 0.5 (Shrivastava et al. 2017). Seeded numpy, so it
picks as the JAX package's pool does, pick for pick.
"""

from __future__ import annotations

import numpy as np


class ImagePool:
    def __init__(self, pool_size: int = 50, seed: int = 0):
        self.pool_size = pool_size
        self.pool: list = []
        self.rng = np.random.RandomState(seed)

    def query(self, images: np.ndarray) -> np.ndarray:
        """(B, H, W, C) host array -> a same-shape array mixing history."""
        if self.pool_size == 0:
            return images
        out = []
        for image in np.asarray(images):
            if len(self.pool) < self.pool_size:
                self.pool.append(image)
                out.append(image)
            elif self.rng.uniform() > 0.5:
                idx = self.rng.randint(0, self.pool_size)
                out.append(self.pool[idx])
                self.pool[idx] = image
            else:
                out.append(image)
        return np.stack(out, axis=0)
