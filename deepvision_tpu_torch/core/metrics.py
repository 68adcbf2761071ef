"""Metrics (own copy of deepvision_tpu/core/metrics.py): the JSONL +
console + TensorBoard stream `MetricsLogger` with its in-memory `history`
(under a process group only rank 0 writes and echoes), and the dense
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
    """Console echo always; `<log_dir>/<name>.jsonl` and TensorBoard
    scalars under `<log_dir>/tb/<name>` when a log dir is given; all on
    rank 0 only under a process group. A new JSONL file starts with the
    provenance header `{"meta": {...}}` (JAX's keys, torch's values); a
    resumed run appends to its file and keeps its one header. One lock
    keeps interleaved JSONL lines whole: the serving stack flushes from
    its lifecycle thread while request threads log refusals. `history`
    maps each prefixed key to {"epochs": [...], "value": [...]} (the
    epoch, or the step when none is given), as the JAX logger's.
    `device` is what the run computes on (None: the card when there is
    one)."""

    def __init__(self, log_dir: Optional[str] = None, name: str = "serve",
                 tensorboard: bool = True, device=None):
        self.log_dir = log_dir
        self.name = name
        self.history: Dict[str, Dict[str, list]] = {}
        self._lock = threading.Lock()
        self._jsonl = None
        self._tb = None
        self._main = mesh.is_main_process()
        # created on the first log, as JAX's: a run that logs nothing
        # never imports tensorboard
        self._tb_pending = bool(log_dir) and tensorboard and self._main
        if log_dir and self._main:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
            if self._jsonl.tell() == 0:
                self._jsonl.write(json.dumps({"meta": meta_header(device)})
                                  + "\n")
                self._jsonl.flush()
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "",
            echo: bool = True,
            extra: Optional[Dict[str, str]] = None,
            epoch: Optional[int] = None) -> None:
        """`extra` carries non-numeric correlation fields (request_id) onto
        the JSONL line only (history and TensorBoard are scalar stores);
        `epoch`, when given, goes on the line and into the console echo."""
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
            if self._tb_pending:
                self._tb_pending = False
                self._tb = make_tb_writer(os.path.join(self.log_dir, "tb",
                                                       self.name))
            if self._tb is not None:
                for k, v in metrics.items():
                    self._tb.add_scalar(prefix + k, v, global_step=step)
                self._tb.flush()
        if echo and self._main:
            body = " ".join(f"{prefix + k}={v:.4f}" for k, v in metrics.items())
            where = f"epoch {epoch} " if epoch is not None else ""
            print(f"[{self.name}] {where}step {step}: {body}", flush=True)

    def close(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None
            if self._tb is not None:
                self._tb.close()
                self._tb = None


def meta_header(device=None) -> dict:
    """The run log's provenance (the keys of
    deepvision_tpu/core/metrics.py's header, `torch_version` in place of
    `jax_version`): the platform ("gpu" or "cpu") and device kind of
    `device` (None: the card when there is one), the world size and this
    process's rank in it."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    gpu = device.type == "cuda"
    world = mesh.world_size()
    return {"platform": "gpu" if gpu else "cpu",
            "device_kind": torch.cuda.get_device_name(device) if gpu
            else "cpu",
            "n_devices": world,
            "process": f"{mesh.rank()}/{world}",
            "torch_version": torch.__version__,
            "started_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}


class EventWriter:
    """TensorBoard scalars: one `events.out.tfevents.*` file of Event protos
    in TFRecord framing, written with tensorboard's own record writer and
    protos. `torch.utils.tensorboard.SummaryWriter` writes the same file,
    but through tensorboard's compat layer, which imports TensorFlow
    wherever it is installed (14 s, and the port never loads TensorFlow);
    tensorboard's switch that keeps it off (its `notf` marker) swaps
    TensorFlow's own `tf.summary` for a stub in the whole process, which
    breaks the JAX logger running beside the port."""

    def __init__(self, path: str):
        import socket

        from tensorboard.compat.proto import event_pb2, summary_pb2
        from tensorboard.summary.writer.record_writer import RecordWriter
        self._event, self._summary = event_pb2.Event, summary_pb2.Summary
        os.makedirs(path, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}."
                f"{socket.gethostname()}.{os.getpid()}.0")
        self._file = open(os.path.join(path, name), "wb")
        self._records = RecordWriter(self._file)
        self._write(self._event(wall_time=time.time(),
                                file_version="brain.Event:2"))
        self.flush()

    def _write(self, event) -> None:
        self._records.write(event.SerializeToString())

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        self._write(self._event(
            wall_time=time.time(), step=int(global_step),
            summary=self._summary(value=[self._summary.Value(
                tag=tag, simple_value=float(value))])))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def make_tb_writer(path: str) -> Optional[EventWriter]:
    """A TensorBoard scalar writer under `path`, or None when the
    `tensorboard` package is absent, as JAX's writer is None without
    TensorFlow."""
    try:
        return EventWriter(path)
    except ImportError:        # tensorboard is optional, as TF is in JAX
        return None


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
