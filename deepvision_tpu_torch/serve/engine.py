"""Shape-bucketed predict engine (port of deepvision_tpu/serve/engine.py).

Incoming batches are padded up to the nearest bucket ({1, 8, 32,
max_batch} by default) and the padding rows are stripped from the outputs;
in inference mode rows are independent, so padding cannot contaminate real
outputs — pinned by tests/test_torch_serve.py against `reference`. PyTorch
runs eagerly, so a bucket here bounds the set of shapes the kernels and
cuBLAS see rather than a set of compiled programs; a CUDA graph per bucket
is the counterpart of the JAX engine's AOT executables (ROADMAP).

Dtype policy matches the JAX engine: inputs cast to the config's compute
dtype (bf16 unless the config pins f32), outputs returned as f32.
"""

from __future__ import annotations

import threading
import time
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..core.steps import normalize_input
from ..models import build_model
from ..utils.device import device_name, resolve_device


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets ascending). Raises past the largest
    bucket — predict() chunks oversize batches before calling this, and the
    batcher never coalesces past max_batch."""
    if n < 1:
        raise ValueError(f"need at least one example, got {n}")
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket {buckets[-1]}")


class PredictEngine:
    """Bucketed predict over `model(x)` on one device.

    `predict(images)` accepts a host array of shape `(n, *example_shape)`
    (or one bare example), pads to the nearest bucket, runs ONE dispatch
    per <=max_batch chunk, and returns the f32 host outputs with the
    padding rows stripped. Thread-safe: the model is only read, and each
    dispatch runs under `torch.inference_mode()`.

    The model must carry its compute dtype as `model.dtype` and implement
    `cast_compute_weights_()` (models/vit.py).
    """

    def __init__(self, model: torch.nn.Module, *,
                 example_shape: Sequence[int],
                 device=None,
                 buckets: Sequence[int] = (1, 8, 32),
                 max_batch: Optional[int] = None,
                 input_norm: Optional[Tuple] = None,
                 name: str = "model", verbose: bool = True,
                 provenance: Optional[dict] = None):
        self.device = resolve_device(device)
        bs = sorted({int(b) for b in buckets})
        if not bs or bs[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        max_batch = int(max_batch) if max_batch else bs[-1]
        if max_batch < bs[-1]:
            raise ValueError(f"max_batch={max_batch} below the largest "
                             f"bucket {bs[-1]}")
        if max_batch not in bs:
            bs.append(max_batch)  # the {1, 8, 32, max_batch} policy
        self.buckets: Tuple[int, ...] = tuple(bs)
        self.max_batch = max_batch
        self.example_shape = tuple(example_shape)
        self.name = name
        self.verbose = verbose
        self.provenance = dict(provenance or {"weights": "random-init"})
        self.input_norm = input_norm
        self.input_dtype = np.dtype(np.uint8 if input_norm is not None
                                    else np.float32)
        self.compute_dtype = model.dtype
        # weights are placed and cast to the compute dtype ONCE, here: a
        # per-request cast would read the f32 copy and write a bf16 one on
        # every dispatch, more weight traffic than the dispatch itself
        # needs. LayerNorms and the head stay f32 (the model's policy).
        self.model = model.eval().to(self.device).cast_compute_weights_()
        self.device_name = device_name(self.device)
        self._lock = threading.Lock()
        #: bucketed dispatches run so far (warmup included): every one runs
        #: the model once at its bucket's batch size
        self.dispatches = 0

    @classmethod
    def from_config(cls, name: str, *, device=None,
                    buckets: Sequence[int] = (1, 8, 32),
                    max_batch: Optional[int] = None,
                    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                    verbose: bool = True) -> "PredictEngine":
        """Build an engine for a registered config: weights drawn from
        `cfg.seed` through a `torch.Generator`, or `state_dict` (e.g. JAX
        params carried over by utils/flax_convert.py)."""
        device = resolve_device(device)   # fail before building anything
        cfg = get_config(name)
        if cfg.family != "classification":
            raise ValueError(f"config {name!r} is {cfg.family}; the port "
                             f"serves classification models only so far")
        model = build_model(cfg)
        provenance = {"weights": "random-init", "seed": cfg.seed}
        if state_dict is not None:
            model.load_state_dict(state_dict)
            provenance = {"weights": "state_dict"}
        input_norm = ((cfg.data.mean, cfg.data.std)
                      if cfg.data.normalize_on_device else None)
        size = cfg.data.image_size
        return cls(model, example_shape=(size, size, cfg.data.channels),
                   device=device, buckets=buckets, max_batch=max_batch,
                   input_norm=input_norm, name=cfg.name, verbose=verbose,
                   provenance=provenance)

    # -- dispatch ----------------------------------------------------------

    def _run(self, x: np.ndarray) -> np.ndarray:
        """One forward at exactly x's batch size; f32 host output."""
        with torch.inference_mode():
            images = torch.from_numpy(x).to(self.device)
            out = self.model(normalize_input(images, self.input_norm,
                                             self.compute_dtype))
            return out.float().cpu().numpy()

    def _dispatch(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        b = pick_bucket(n, self.buckets)
        if b != n:
            x = np.pad(x, [(0, b - n)] + [(0, 0)] * (x.ndim - 1))
        with self._lock:
            self.dispatches += 1
        return self._run(x)[:n]

    def warmup(self) -> None:
        """One blocking dispatch per bucket: absorbs first-call allocation,
        kernel build and cuBLAS setup so the first request doesn't pay it."""
        x = np.zeros((self.max_batch, *self.example_shape), self.input_dtype)
        for b in self.buckets:
            t0 = time.perf_counter()
            self._dispatch(x[:b])
            if self.verbose:
                print(f"[serve:{self.name}] bucket {b}: warm in "
                      f"{time.perf_counter() - t0:.2f}s on "
                      f"{self.device_name}", flush=True)

    def _coerce(self, images) -> np.ndarray:
        x = np.asarray(images, self.input_dtype)
        if x.shape == self.example_shape:
            x = x[None]
        if x.ndim != len(self.example_shape) + 1 \
                or x.shape[1:] != self.example_shape:
            raise ValueError(
                f"expected (n, {', '.join(map(str, self.example_shape))}) "
                f"(or one bare example), got {x.shape}")
        return x

    def predict(self, images) -> np.ndarray:
        """Host-in host-out bucketed prediction (pads, dispatches, strips).
        Oversize batches run as max_batch chunks plus one tail bucket."""
        x = self._coerce(images)
        if x.shape[0] <= self.max_batch:
            return self._dispatch(x)
        return np.concatenate([self._dispatch(x[i:i + self.max_batch])
                               for i in range(0, x.shape[0],
                                              self.max_batch)])

    def reference(self, images) -> np.ndarray:
        """Un-bucketed predict at the exact batch size — the oracle the
        padding-equivalence checks hold the bucketed path against."""
        return self._run(self._coerce(images))

    # -- measurement -------------------------------------------------------

    def measure_batch_ms(self, bucket: Optional[int] = None,
                         iters: int = 5) -> float:
        """Steady-state wall time of one dispatch of `bucket` (default
        max_batch), host input to host output, in ms — the "one batch
        compute time" term of the serving latency contract."""
        b = pick_bucket(bucket or self.max_batch, self.buckets)
        x = np.zeros((b, *self.example_shape), self.input_dtype)
        self._run(x)  # warm; _run ends in a device-to-host copy, so each
        t0 = time.perf_counter()  # timed call includes the device work
        for _ in range(iters):
            self._run(x)
        return (time.perf_counter() - t0) / iters * 1000.0
