"""Metrics (own copy of parts of deepvision_tpu/core/metrics.py): the
JSONL + console stream `MetricsLogger` with its in-memory `history`
(under a process group only rank 0 writes and echoes; TensorBoard output
is not ported yet), and the dense
prediction metrics `confusion_matrix`, `segmentation_scores` and
`StreamingConfusion`.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel import mesh


class MetricsLogger:
    """Console echo always; `<log_dir>/<name>.jsonl` when a log dir is
    given; both on rank 0 only under a process group. One lock keeps
    interleaved JSONL lines whole: the serving stack flushes from its
    lifecycle thread while request threads log refusals. `history` maps
    each prefixed key to {"epochs": [...], "value": [...]} (the epoch, or
    the step when none is given), as the JAX logger's."""

    def __init__(self, log_dir: Optional[str] = None, name: str = "serve"):
        self.name = name
        self.history: Dict[str, Dict[str, list]] = {}
        self._lock = threading.Lock()
        self._jsonl = None
        self._main = mesh.is_main_process()
        if log_dir and self._main:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "",
            echo: bool = True,
            extra: Optional[Dict[str, str]] = None,
            epoch: Optional[int] = None) -> None:
        """`extra` carries non-numeric correlation fields (request_id) onto
        the JSONL line only; `epoch`, when given, goes on the line and into
        the console echo."""
        metrics = {k: float(v) for k, v in metrics.items()}
        with self._lock:
            for k, v in metrics.items():
                h = self.history.setdefault(prefix + k,
                                            {"epochs": [], "value": []})
                h["epochs"].append(epoch if epoch is not None else step)
                h["value"].append(v)
            if self._jsonl is not None:
                rec = {"step": step, "t": round(time.time() - self._t0, 3),
                       **({"epoch": epoch} if epoch is not None else {}),
                       **(extra or {})}
                # json.dumps would emit bare NaN/Infinity tokens (invalid
                # JSON); serialize non-finite values as strings instead
                rec.update({prefix + k: (round(v, 6) if math.isfinite(v)
                                         else str(v))
                            for k, v in metrics.items()})
                self._jsonl.write(json.dumps(rec, allow_nan=False) + "\n")
                self._jsonl.flush()
        if echo and self._main:
            body = " ".join(f"{prefix + k}={v:.4f}" for k, v in metrics.items())
            where = f"epoch {epoch} " if epoch is not None else ""
            print(f"[{self.name}] {where}step {step}: {body}", flush=True)

    def close(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) f32 confusion COUNTS, rows the true
    classes and columns the predicted ones, on the labels' device with no
    host sync (a scatter-add over the flattened pixels). Sums over batches
    add elementwise."""
    idx = (labels.reshape(-1).long() * num_classes
           + preds.reshape(-1).long())
    flat = torch.zeros(num_classes * num_classes, dtype=torch.float32,
                       device=labels.device)
    flat.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.float32,
                                       device=labels.device))
    return flat.reshape(num_classes, num_classes)


def segmentation_scores(cm) -> Dict[str, np.ndarray]:
    """{pixel_acc, miou, per_class_iou, present} of a summed confusion
    matrix (host numpy). IoU_c = TP_c / (row_c + col_c - TP_c); the mIoU
    averages the classes present in the ground truth (an absent class
    has IoU nan in `per_class_iou` and is left out)."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    gt = cm.sum(axis=1)
    pred = cm.sum(axis=0)
    union = gt + pred - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.where(union > 0, tp / np.maximum(union, 1), np.nan)
    present = gt > 0
    total = cm.sum()
    return {
        "pixel_acc": float(tp.sum() / total) if total else 0.0,
        "miou": float(np.nanmean(np.where(present, per_class, np.nan)))
        if present.any() else 0.0,
        "per_class_iou": per_class,
        "present": present,
    }


class StreamingConfusion:
    """Host-side sum of per-batch (C, C) confusion matrices; `result()`
    derives pixel accuracy, mIoU and per-class IoU from the sums."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.cm = np.zeros((num_classes, num_classes), np.float64)

    def update(self, cm) -> None:
        cm = np.asarray(cm, np.float64)
        if cm.shape != self.cm.shape:
            raise ValueError(f"confusion matrix shape {cm.shape} != "
                             f"({self.num_classes}, {self.num_classes})")
        self.cm += cm

    def result(self) -> Dict[str, np.ndarray]:
        return segmentation_scores(self.cm)
