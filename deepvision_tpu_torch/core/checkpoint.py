"""Checkpoints (own copy of the core of deepvision_tpu/core/checkpoint.py:
keep-latest plus keep-best, and atomic writes).

One file per epoch, `<directory>/<epoch>.pt`, written by `torch.save` to a
private temporary file and renamed into place, so a reader (or a process
killed mid-save) never sees half a checkpoint. `metrics.json` beside it
maps each kept epoch to its watched metric, for the keep-best policy; it is
replaced the same way. Under a process group rank 0 alone writes, and
every rank leaves `save` only once the checkpoint is committed (a
barrier); every rank reads on restore. Async saves, integrity manifests,
resharding and retries are not ported yet.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel import mesh

_EPOCH_FILE = re.compile(r"^(\d+)\.pt$")
_INDEX = "metrics.json"


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    """Keeps the newest `keep` epochs and, with `keep_best`, the epoch with
    the best metric (`best_mode` "min" or "max") among those saved with
    one."""

    def __init__(self, directory: str, keep: int = 3, keep_best: bool = True,
                 best_mode: str = "max"):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got "
                             f"{best_mode!r}")
        self.directory = directory
        self.keep = max(1, keep)
        self.keep_best = keep_best
        self.best_mode = best_mode
        os.makedirs(directory, exist_ok=True)
        self._metrics = self._read_index()

    def _read_index(self) -> Dict[int, Optional[float]]:
        index = os.path.join(self.directory, _INDEX)
        if not os.path.exists(index):
            return {}
        with open(index) as fh:
            return {int(k): v for k, v in json.load(fh).items()}

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{epoch}.pt")

    def epochs(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _EPOCH_FILE.match(f)))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def best_epoch(self) -> Optional[int]:
        scored = [(m, e) for e, m in self._metrics.items()
                  if m is not None and math.isfinite(m)
                  and os.path.exists(self._path(e))]
        if not scored:
            return None
        pick = min if self.best_mode == "min" else max
        return pick(scored)[1]

    def save(self, epoch: int, payload: Dict[str, Any],
             metric: Optional[float] = None) -> None:
        """Write `payload` as `epoch` (rank 0), then prune; every rank
        returns once it is committed."""
        if mesh.is_main_process():
            self._write(epoch, payload, metric)
        mesh.barrier()
        if not mesh.is_main_process():
            self._metrics = self._read_index()

    def _write(self, epoch: int, payload: Dict[str, Any],
               metric: Optional[float]) -> None:
        _atomic_write(self._path(epoch), lambda p: torch.save(payload, p))
        self._metrics[epoch] = None if metric is None else float(metric)
        keep = set(self.epochs()[-self.keep:])
        best = self.best_epoch() if self.keep_best else None
        if best is not None:
            keep.add(best)
        for e in self.epochs():
            if e not in keep:
                os.remove(self._path(e))
        self._metrics = {e: m for e, m in self._metrics.items() if e in keep}

        def write_index(p):
            with open(p, "w") as fh:
                json.dump({str(e): m for e, m in sorted(self._metrics.items())},
                          fh)
        _atomic_write(os.path.join(self.directory, _INDEX), write_index)

    def restore(self, epoch: Optional[int] = None
                ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(epoch, payload) of `epoch` (the latest when None), on the CPU;
        None when nothing is saved. A named epoch that is missing raises."""
        if epoch is None:
            epoch = self.latest_epoch()
            if epoch is None:
                return None
        elif not os.path.exists(self._path(epoch)):
            raise FileNotFoundError(f"no checkpoint for epoch {epoch} in "
                                    f"{self.directory} (saved: "
                                    f"{self.epochs()})")
        payload = torch.load(self._path(epoch), map_location="cpu",
                             weights_only=True)
        return epoch, payload
