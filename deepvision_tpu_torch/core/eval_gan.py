"""Generator evaluation by the Frechet distance of classifier features
(own copy of deepvision_tpu/core/eval_gan.py: `gaussian_stats`,
`_psd_sqrt`, `frechet_distance`, `frechet_from_features`,
`lenet_feature_fn`).

The distance (Heusel et al. 2017) between Gaussian fits of real and
generated feature activations; the features are the port's LeNet-5
penultimate layer (F6, 84-dim) on MNIST-shaped images. All math is numpy
with eigendecompositions, which stay real and exact for the PSD inputs
that covariance matrices are.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean vector and covariance of an (N, D) feature matrix, f64."""
    f = np.asarray(features, dtype=np.float64)
    if f.ndim != 2:
        raise ValueError(f"features must be (N, D), got {f.shape}")
    if f.shape[0] < 2:
        raise ValueError("need at least 2 samples for a covariance")
    return f.mean(axis=0), np.cov(f, rowvar=False)


def _psd_sqrt(mat: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root via eigh; negative eigenvalues from
    rounding are clipped to zero."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    return (vecs * np.sqrt(np.clip(vals, 0.0, None))) @ vecs.T


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray,
                     mu2: np.ndarray, cov2: np.ndarray) -> float:
    """d^2 = |mu1 - mu2|^2 + tr(C1 + C2 - 2 (C1^1/2 C2 C1^1/2)^1/2), the
    symmetrized form of tr sqrt(C1 C2)."""
    diff = np.asarray(mu1, np.float64) - np.asarray(mu2, np.float64)
    s1 = _psd_sqrt(np.asarray(cov1, np.float64))
    inner = _psd_sqrt(s1 @ np.asarray(cov2, np.float64) @ s1)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(inner))


def frechet_from_features(real: np.ndarray, generated: np.ndarray) -> float:
    """Frechet distance between two (N, D) feature sets."""
    return frechet_distance(*gaussian_stats(real), *gaussian_stats(generated))


def lenet_feature_fn(model: torch.nn.Module, image_size: int = 32
                     ) -> Callable[[np.ndarray], np.ndarray]:
    """The F6 embedding (84-dim, before its tanh) of a trained LeNet-5
    (`models/lenet.py`, on its own device) as a function of (N, H, W, 1)
    images in [-1, 1]; smaller images are padded symmetrically with -1 (the
    background the classifier was trained on) up to `image_size`."""

    def features(images: np.ndarray) -> np.ndarray:
        x = np.asarray(images, np.float32)
        pad = image_size - x.shape[1]
        if pad < 0:
            raise ValueError(
                f"lenet_feature_fn: images are {x.shape[1]}px but the "
                f"feature extractor was built for {image_size}px — larger "
                "inputs would hit LeNet with a receptive field it was never "
                "trained on; resize the images or rebuild with a matching "
                "image_size")
        if pad > 0:
            lo, hi = pad // 2, pad - pad // 2
            x = np.pad(x, ((0, 0), (lo, hi), (lo, hi), (0, 0)),
                       constant_values=-1.0)
        device = next(model.parameters()).device
        with torch.inference_mode():
            return model.eval().penultimate(
                torch.from_numpy(x).to(device)).float().cpu().numpy()

    return features
