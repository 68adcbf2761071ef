"""Checkpoints with an integrity layer (own copy of
deepvision_tpu/core/checkpoint.py: keep-latest and keep-best, async save,
integrity manifests, verified restore with quarantine and fallback, and
retries).

Layout, as the JAX package's: `<directory>/<epoch>/` holds `state.pt` (the
`torch.save` of the state's tensor tree) and `host.json` (the host
metadata: best metric, plateau state), and `integrity_manifest.json`
(core/integrity.py), written last and atomically: its presence certifies
the commit. An epoch's files are written into a temporary directory that a
rename commits as `<epoch>`, so a pure-digit directory is a committed
payload. `metrics.json` beside the epochs maps each kept epoch to its
watched metric, for the keep-best policy.

- **Async save.** `save()` copies the state to host memory and returns: a
  card's tensors are copied into pinned buffers on the current stream
  (ordered before any later in-place update of the same tensors) and an
  event is recorded; the CPU's are cloned. A writer thread waits on the
  event, writes, commits, hashes the snapshot's leaves and files, and
  commits the manifest. Its failure is captured and raised again at the
  next `save()` (through the `ckpt_save` retry path) or `flush()`. The
  pinned buffers are reused by the next save once the writer is done with
  them.
- **Verified restore.** `restore(verify="fallback")` checks the newest
  epoch's files against its manifest, loads it, checks the loaded leaves
  against the manifest's hashes, and on any mismatch renames the epoch to
  `corrupt-<epoch>/` and falls back to the next-newest generation that
  verifies; "strict" raises `CheckpointCorruptionError` and quarantines
  nothing; "off" restores blindly. When every generation is corrupt,
  restore raises. A directory with no manifest anywhere (written before
  this layer), and the earlier port's `<epoch>.pt` files, restore with a
  warning as unverified legacy checkpoints.
- **Retries.** The save's enqueue and the restore's load run under
  `call_with_retry` (transient OSError backs off; `on_retry` is the
  trainers' logging hook).
- **Process groups.** Rank 0 alone writes and decides what a restore
  loads (including the quarantine), and broadcasts the epoch; `flush()`,
  `restore()` and the epoch queries are collective, so no rank reads an
  epoch before its manifest exists. A checkpoint is whole under DDP: any
  world size restores it natively.

Elastic resharding (a mesh section in the manifest) is not ported.
"""

from __future__ import annotations

import json
import math
import os
import queue
import re
import shutil
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel import mesh
from . import integrity
from .integrity import CheckpointCorruptionError  # noqa: F401 — re-export
from .resilience import RetryPolicy, call_with_retry

# restore() verification modes; True/False/None are aliases for bool callers
VERIFY_MODES = ("fallback", "strict", "off")
STATE_FILE = "state.pt"
HOST_FILE = "host.json"
_LEGACY_FILE = re.compile(r"^(\d+)\.pt$")
_TMP_DIR = re.compile(r"^\.tmp-(\d+)-(\d+)$")
_INDEX = "metrics.json"


def host_snapshot(tree: Any, buffers: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[Any, List[torch.cuda.Event],
                             Dict[str, torch.Tensor]]:
    """A host copy of a tree of tensors (dicts, lists, tuples; other leaves
    kept as they are), `(copy, events, pinned buffers by key)`. A card's
    tensor is copied into a pinned buffer (`buffers[key]` when its shape
    and dtype fit) without blocking, on its card's current stream, so a
    later in-place update on that stream runs after the copy; the copy is
    complete once every event has. A CPU tensor is cloned."""
    streams: Dict[torch.device, Any] = {}
    used: Dict[str, torch.Tensor] = {}

    def copy(key: str, leaf):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if not t.is_cuda:
                return t.clone()
            buf = (buffers or {}).get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.device(t.device):
                buf.copy_(t, non_blocking=True)
            streams.setdefault(t.device, torch.cuda.current_stream(t.device))
            used[key] = buf
            return buf
        if isinstance(leaf, dict):
            return {k: copy(f"{key}.{k}" if key else str(k), v)
                    for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(copy(f"{key}.{i}" if key else str(i), v)
                              for i, v in enumerate(leaf))
        return leaf

    out = copy("", tree)
    events = []
    for device, stream in streams.items():
        event = torch.cuda.Event()
        event.record(stream)
        events.append(event)
    return out, events, used


def _fsync_file(path: str) -> None:
    with open(path, "rb") as fp:
        os.fsync(fp.fileno())


def _atomic_json(path: str, obj) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class CheckpointManager:
    """Keeps the newest `keep` epochs and, with `keep_best`, the epoch with
    the best metric (`best_mode` "min" or "max") among those saved with
    one. `fault_injector` (utils/faults.py) provides the
    deterministic write failures and the post-commit corruption of the
    tests and the chip smoke."""

    def __init__(self, directory: str, keep: int = 3, keep_best: bool = True,
                 best_mode: str = "max",
                 retry_policy: Optional[RetryPolicy] = None,
                 on_retry=None, fault_injector=None):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got "
                             f"{best_mode!r}")
        self.directory = os.path.abspath(directory)
        self.keep = max(1, keep)
        self.keep_best = keep_best
        self.best_mode = best_mode
        self.retry_policy = retry_policy or RetryPolicy()
        self.on_retry = on_retry
        self.fault_injector = fault_injector
        os.makedirs(self.directory, exist_ok=True)
        self._metrics = self._read_index()
        #: provenance of the last restore: {epoch, verified, mode,
        #: manifest_sha256, fallback_skipped | legacy, resharded}
        self.last_restore_info: Optional[Dict[str, Any]] = None
        #: seconds the last save() blocked its caller (the snapshot)
        self.last_save_block_secs: Optional[float] = None
        #: the writer's record of its last commit: epoch, write_secs,
        #: hash_secs, bytes
        self.last_commit: Optional[Dict[str, Any]] = None
        self._q: "queue.Queue" = queue.Queue()
        self._async_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._free_buffers: Optional[Dict[str, torch.Tensor]] = None
        self._writer: Optional[threading.Thread] = None
        if mesh.is_main_process():
            self._remove_stale_tmp()

    # -- layout ------------------------------------------------------------
    def _step_dir(self, epoch: int) -> str:
        return os.path.join(self.directory, str(epoch))

    def _legacy_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{epoch}.pt")

    def _remove_stale_tmp(self) -> None:
        """Drop the temporary directories of writers that died mid-save."""
        for name in os.listdir(self.directory):
            m = _TMP_DIR.match(name)
            if m and not _pid_alive(int(m.group(2))):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def epochs(self) -> List[int]:
        """Committed epochs, ascending: `<epoch>/` directories and legacy
        `<epoch>.pt` files."""
        legacy = {int(m.group(1)) for f in os.listdir(self.directory)
                  if (m := _LEGACY_FILE.match(f))}
        return sorted(set(integrity.committed_epochs(self.directory))
                      | legacy)

    def _read_index(self) -> Dict[int, Optional[float]]:
        index = os.path.join(self.directory, _INDEX)
        if not os.path.exists(index):
            return {}
        with open(index) as fh:
            return {int(k): v for k, v in json.load(fh).items()}

    @staticmethod
    def _log(msg: str) -> None:
        print(f"[ckpt] {msg}", file=sys.stderr, flush=True)

    # -- async failures ------------------------------------------------------
    def _record_async_failure(self, exc: BaseException) -> None:
        with self._lock:
            if self._async_error is None:   # the first failure names the
                self._async_error = exc     # epoch that actually broke

    def _reraise_async_failure(self) -> None:
        with self._lock:
            err, self._async_error = self._async_error, None
        if err is not None:
            raise err

    # -- the writer ----------------------------------------------------------
    def _ensure_writer(self) -> None:
        if self._writer is None:
            self._writer = threading.Thread(target=self._write_loop,
                                            daemon=True, name="ckpt-writer")
            self._writer.start()

    def _write_loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._commit(*item)
            except BaseException as e:  # noqa: BLE001 — captured, raised
                self._record_async_failure(e)  # at the next barrier
            finally:
                self._q.task_done()

    def _commit(self, epoch: int, state, host: dict,
                metric: Optional[float], events: list,
                buffers: Dict[str, torch.Tensor]) -> None:
        """Write, commit, hash, stamp the manifest, prune; then the
        injector's post-commit corruption, if armed."""
        if self.fault_injector is not None:
            self.fault_injector.during_async_save()
        for event in events:
            event.synchronize()
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f".tmp-{epoch}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, HOST_FILE), "w") as fh:
            json.dump(host, fh, sort_keys=True)
        for name in (STATE_FILE, HOST_FILE):
            _fsync_file(os.path.join(tmp, name))
        final = self._step_dir(epoch)
        if os.path.isdir(final):
            self._log(f"epoch {epoch} saved again: the new save replaces "
                      f"the committed one")
            shutil.rmtree(final)
        if os.path.exists(self._legacy_path(epoch)):
            os.remove(self._legacy_path(epoch))
        os.rename(tmp, final)
        t1 = time.perf_counter()
        files = integrity.hash_tree_files(final)
        manifest = integrity.build_manifest(
            epoch=epoch, leaves=integrity.leaf_entries(state), files=files,
            writer={"async_save": True, "rank": mesh.rank(),
                    "host_state_keys": sorted(host),
                    "torch": torch.__version__})
        integrity.write_manifest(final, manifest)
        t2 = time.perf_counter()
        self._metrics[epoch] = None if metric is None else float(metric)
        self._prune()
        with self._lock:
            self._free_buffers = buffers or self._free_buffers
        self.last_commit = {"epoch": epoch, "write_secs": t1 - t0,
                            "hash_secs": t2 - t1,
                            "bytes": manifest["total_bytes"]}
        if self.fault_injector is not None:
            self.fault_injector.corrupt_checkpoint(
                epoch, final, manifest_name=integrity.MANIFEST_NAME)

    def _best_of(self, metrics: Dict[int, Optional[float]],
                 present: List[int]) -> Optional[int]:
        scored = [(m, e) for e, m in metrics.items()
                  if e in present and m is not None and math.isfinite(m)]
        if not scored:
            return None
        pick = min if self.best_mode == "min" else max
        return pick(scored)[1]

    def _prune(self) -> None:
        epochs = self.epochs()
        keep = set(epochs[-self.keep:])
        best = self._best_of(self._metrics, epochs) if self.keep_best \
            else None
        if best is not None:
            keep.add(best)
        for e in epochs:
            if e in keep:
                continue
            if os.path.isdir(self._step_dir(e)):
                shutil.rmtree(self._step_dir(e))
            if os.path.exists(self._legacy_path(e)):
                os.remove(self._legacy_path(e))
        self._metrics = {e: m for e, m in self._metrics.items() if e in keep}
        _atomic_json(os.path.join(self.directory, _INDEX),
                     {str(e): m for e, m in sorted(self._metrics.items())})

    # -- save ----------------------------------------------------------------
    def save(self, epoch: int, state, host_state: Optional[dict] = None,
             metric: Optional[float] = None) -> None:
        """Save `state` (a tree of tensors: a state dict) with `host_state`
        (JSON) as `epoch`: rank 0 snapshots it to the host and hands it to
        the writer; the call returns without waiting for the write. A
        failure of an earlier background write re-raises here first,
        through the `ckpt_save` retry path, as does the injector's
        transient save failure."""
        if mesh.is_main_process():
            t0 = time.perf_counter()
            with self._lock:
                buffers, self._free_buffers = self._free_buffers, None
            snap, events, used = host_snapshot(state, buffers)
            host = json.loads(json.dumps(host_state or {}))

            def enqueue():
                self._reraise_async_failure()
                if self.fault_injector is not None:
                    self.fault_injector.before_checkpoint_save()
                self._ensure_writer()
                self._q.put((epoch, snap, host, metric, events, used))

            call_with_retry(enqueue, self.retry_policy, what="ckpt_save",
                            on_retry=self.on_retry)
            self.last_save_block_secs = time.perf_counter() - t0

    @property
    def writing(self) -> bool:
        """Whether a save handed to the writer is not committed yet."""
        return self._q.unfinished_tasks > 0

    # -- barriers ------------------------------------------------------------
    def _drain(self) -> None:
        """Wait for every queued write (no re-raise: that is flush's)."""
        self._q.join()

    def _sync(self) -> None:
        """Every queued write committed, on every rank."""
        self._drain()
        mesh.barrier()

    def flush(self) -> None:
        """Barrier on every in-flight save and its manifest (on every rank
        under a process group), then re-raise a failure captured from the
        background write; under a process group the other ranks raise
        too."""
        self._drain()
        failed = mesh.agree_any(self._async_error is not None)
        self._reraise_async_failure()
        if failed:
            raise RuntimeError(f"a checkpoint write into {self.directory} "
                               f"failed on rank 0")

    # -- queries -------------------------------------------------------------
    def latest_epoch(self) -> Optional[int]:
        self._sync()
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def best_epoch(self) -> Optional[int]:
        self._sync()
        return self._best_of(self._read_index(), self.epochs())

    # -- restore -------------------------------------------------------------
    def restore(self, epoch: Optional[int] = None, verify: Any = "fallback"
                ) -> Tuple[Any, dict, Optional[int]]:
        """`(state, host_state, epoch)` of `epoch` (the latest when None),
        on the CPU; `(None, {}, None)` when nothing is committed. A named
        epoch that is missing raises FileNotFoundError. `verify`:
        "fallback", "strict" or "off" (see the module)."""
        mode = {True: "fallback", False: "off", None: "fallback"}.get(
            verify, verify)
        if mode not in VERIFY_MODES:
            raise ValueError(f"verify must be one of {VERIFY_MODES} (or a "
                             f"bool), got {verify!r}")
        self._sync()
        plan, loaded = None, None
        if mesh.is_main_process():
            try:
                loaded, info = self._choose(epoch, mode)
                plan = ("ok", info)
            except Exception as e:  # noqa: BLE001 — raised on every rank
                plan = ("error", e)
        plan = mesh.broadcast_object(plan)
        if plan[0] == "error":
            raise plan[1]
        info = plan[1]
        if info is None:
            return None, {}, None
        self.last_restore_info = info
        if loaded is None:      # another rank: rank 0 verified this epoch
            loaded = self._load(info["epoch"], legacy=info.get("legacy_file",
                                                               False))
        return loaded[0], loaded[1], info["epoch"]

    def _load(self, epoch: int, legacy: bool = False) -> Tuple[Any, dict]:
        """(state, host) of one committed epoch, on the CPU."""
        if legacy:
            payload = call_with_retry(
                lambda: torch.load(self._legacy_path(epoch),
                                   map_location="cpu", weights_only=True),
                self.retry_policy, what="ckpt_restore",
                on_retry=self.on_retry)
            if isinstance(payload, dict) and set(payload) == {"state",
                                                              "host"}:
                return payload["state"], dict(payload["host"] or {})
            return payload, {}
        step_dir = self._step_dir(epoch)

        def load():
            state = torch.load(os.path.join(step_dir, STATE_FILE),
                               map_location="cpu", weights_only=True)
            host_path = os.path.join(step_dir, HOST_FILE)
            host = {}
            if os.path.exists(host_path):
                with open(host_path) as fh:
                    host = json.load(fh)
            return state, host

        return call_with_retry(load, self.retry_policy, what="ckpt_restore",
                               on_retry=self.on_retry)

    def _choose(self, epoch: Optional[int], mode: str):
        """Rank 0's restore: `((state, host), info)` of the epoch that
        verifies (quarantining the ones that do not, in fallback mode), or
        `(None, None)` when nothing is committed."""
        epochs = self.epochs()
        if epoch is not None and epoch not in epochs:
            raise FileNotFoundError(
                f"no committed checkpoint at epoch {epoch} in "
                f"{self.directory} (committed: {epochs or 'none'})")
        candidates = [e for e in reversed(epochs)
                      if epoch is None or e <= epoch]
        if not candidates:
            return None, None
        base = {"mode": mode, "resharded": False}

        def legacy(e: int, why: str):
            self._log(f"epoch {e}: {why} — restoring unverified")
            is_file = not os.path.isdir(self._step_dir(e))
            return self._load(e, legacy=is_file), {
                **base, "epoch": e, "verified": False, "legacy": True,
                "legacy_file": is_file, "manifest_sha256": None}

        if mode == "off":
            e = candidates[0]
            is_file = not os.path.isdir(self._step_dir(e))
            return self._load(e, legacy=is_file), {
                **base, "epoch": e, "verified": False, "legacy_file": is_file,
                "manifest_sha256": None}
        any_manifest = any(
            os.path.exists(integrity.manifest_path(self._step_dir(e)))
            for e in epochs)
        attempts = []
        for skipped, e in enumerate(candidates):
            step_dir = self._step_dir(e)
            if not os.path.isdir(step_dir):
                return legacy(e, "an earlier port's <epoch>.pt file (legacy "
                                 "checkpoint, predates verification)")
            status, detail = integrity.verify_files(step_dir)
            if status == integrity.MISSING_MANIFEST and not any_manifest:
                return legacy(e, "no integrity manifest (legacy checkpoint, "
                                 "predates verification)")
            if status == integrity.MISSING_MANIFEST:
                problem = (f"epoch {e}: manifest missing while sibling "
                           f"epochs carry one — save interrupted before the "
                           f"manifest committed?")
            elif status == integrity.CORRUPT:
                problem = f"epoch {e}: {detail}"
            else:
                loaded = self._load(e)
                manifest = integrity.load_manifest(step_dir)
                mismatches = integrity.verify_leaves(loaded[0], manifest)
                if not mismatches:
                    if skipped:
                        self._log(f"restored epoch {e} after skipping "
                                  f"{skipped} bad generation(s)")
                    return loaded, {
                        **base, "epoch": e, "verified": True,
                        "manifest_sha256": integrity.manifest_digest(
                            manifest),
                        "fallback_skipped": skipped}
                problem = (f"epoch {e}: loaded tensors disagree with the "
                           f"manifest: " + "; ".join(mismatches[:3]))
            if mode == "strict":
                raise CheckpointCorruptionError(
                    f"{problem} — refusing to restore (verify='strict'). "
                    f"Audit with `python -m deepvision_tpu_torch fsck "
                    f"{self.directory}`, or restore in fallback mode to use "
                    f"an older generation.")
            dest = integrity.quarantine_epoch(self.directory, e)
            self._log(f"QUARANTINED {problem} -> {os.path.basename(dest)}; "
                      f"falling back to the next-newest checkpoint")
            attempts.append(problem)
        raise CheckpointCorruptionError(
            f"no checkpoint in {self.directory} passed verification: "
            + " | ".join(attempts))

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Finish the queued writes, stop the writer, and raise a failure
        that no later save() or flush() observed."""
        if self._writer is not None:
            self._drain()
            self._q.put(None)
            self._writer.join(timeout=60)
            self._writer = None
        self._reraise_async_failure()
