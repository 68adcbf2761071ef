"""Metrics stream (the JSONL + console part of
deepvision_tpu/core/metrics.py::MetricsLogger, own copy). TensorBoard
output arrives with the training slice.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, Optional


class MetricsLogger:
    """Console echo always; `<log_dir>/<name>.jsonl` when a log dir is
    given. One lock keeps interleaved JSONL lines whole: the serving stack
    flushes from its lifecycle thread while request threads log refusals."""

    def __init__(self, log_dir: Optional[str] = None, name: str = "serve"):
        self.name = name
        self._lock = threading.Lock()
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "",
            echo: bool = True,
            extra: Optional[Dict[str, str]] = None) -> None:
        """`extra` carries non-numeric correlation fields (request_id) onto
        the JSONL line only."""
        metrics = {k: float(v) for k, v in metrics.items()}
        with self._lock:
            if self._jsonl is not None:
                rec = {"step": step, "t": round(time.time() - self._t0, 3),
                       **(extra or {})}
                # json.dumps would emit bare NaN/Infinity tokens (invalid
                # JSON); serialize non-finite values as strings instead
                rec.update({prefix + k: (round(v, 6) if math.isfinite(v)
                                         else str(v))
                            for k, v in metrics.items()})
                self._jsonl.write(json.dumps(rec, allow_nan=False) + "\n")
                self._jsonl.flush()
        if echo:
            body = " ".join(f"{prefix + k}={v:.4f}" for k, v in metrics.items())
            print(f"[{self.name}] step {step}: {body}", flush=True)

    def close(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None
