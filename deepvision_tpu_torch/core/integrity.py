"""Checkpoint integrity: manifests, verification, quarantine, fsck (own
copy of deepvision_tpu/core/integrity.py, with the same manifest schema,
so that the JAX package's `verify_files` and `audit` verify a checkpoint
directory the port wrote).

- Every `CheckpointManager.save` commits an **integrity manifest**
  (`integrity_manifest.json` inside the committed epoch directory): the
  per-leaf structure (shape, dtype and a content hash of the host
  snapshot's bytes), a per-file size and sha256 inventory of what
  `torch.save` wrote, and writer metadata. It is written atomically after
  the payload's commit, so its presence certifies that the save finished.
- `verify_files` / `verify_leaves` prove an epoch intact before anything
  consumes it: at the file level without deserializing (fsck's path), and
  at the leaf level against the loaded tensors (restore's deep check).
- `quarantine_epoch` renames a bad epoch to `corrupt-<epoch>`, so a
  fallback restore lands on the next-newest generation that verifies and a
  later save of the same epoch number cannot collide with the bad bytes.
- `audit` drives `python -m deepvision_tpu_torch fsck`.

Leaf keys are the dotted names of the saved state dict: `model.<name>`,
`optimizer.inner.state.<i>.exp_avg`, `step`, `ema.<name>`, and for the
adversarial trainers `gen.model.<name>` and so on. A tensor hashes its
contiguous bytes (bfloat16 too, whose bytes numpy cannot hold); any other
leaf (an int, a float, None) hashes its repr. Everything here is stdlib,
numpy and torch on the host.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

MANIFEST_NAME = "integrity_manifest.json"
MANIFEST_VERSION = 1
QUARANTINE_PREFIX = "corrupt-"

# verification statuses (the audit / verify_files contract; fsck prints them)
OK = "ok"
CORRUPT = "corrupt"
MISSING_MANIFEST = "missing-manifest"
QUARANTINED = "quarantined"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity verification: strict mode refused it,
    or fallback mode exhausted every generation without one verifying."""


def _log(msg: str) -> None:
    print(f"[ckpt-integrity] {msg}", file=sys.stderr, flush=True)


# -- hashing ------------------------------------------------------------------

def file_sha256(path: str, chunk: int = 1 << 20) -> Tuple[int, str]:
    """(size, sha256) of a file, streamed."""
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as fp:
        while True:
            block = fp.read(chunk)
            if not block:
                break
            size += len(block)
            h.update(block)
    return size, h.hexdigest()


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{dotted key: leaf} of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def tensor_entry(t) -> dict:
    """{shape, dtype, sha256} of a host tensor's contiguous bytes."""
    import torch
    flat = t.detach().contiguous().reshape(-1)
    raw = flat.view(torch.uint8) if flat.numel() else flat
    return {"shape": list(t.shape),
            "dtype": str(t.dtype).replace("torch.", ""),
            "sha256": hashlib.sha256(raw.numpy().tobytes()).hexdigest()}


def leaf_entries(payload) -> Dict[str, dict]:
    """Per-leaf {key: {shape, dtype, sha256}} over a payload of host
    tensors; a leaf that is not a tensor hashes its repr instead."""
    import torch
    out: Dict[str, dict] = {}
    for key, leaf in flatten(payload).items():
        if isinstance(leaf, torch.Tensor):
            out[key] = tensor_entry(leaf.cpu())
        else:
            out[key] = {"repr_sha256": hashlib.sha256(
                repr(leaf).encode()).hexdigest()}
    return out


def hash_tree_files(step_dir: str) -> Dict[str, dict]:
    """{relpath: {bytes, sha256}} for every file under a committed epoch
    directory (the manifest itself excluded)."""
    out: Dict[str, dict] = {}
    for root, dirs, files in os.walk(step_dir):
        dirs.sort()
        for f in sorted(files):
            if root == step_dir and f == MANIFEST_NAME:
                continue
            path = os.path.join(root, f)
            rel = os.path.relpath(path, step_dir).replace(os.sep, "/")
            size, digest = file_sha256(path)
            out[rel] = {"bytes": size, "sha256": digest}
    return out


# -- manifest -----------------------------------------------------------------

def build_manifest(*, epoch: int, leaves: Dict[str, dict],
                   files: Dict[str, dict],
                   writer: Optional[dict] = None) -> dict:
    return {
        "format_version": MANIFEST_VERSION,
        "epoch": int(epoch),
        "created_unix": time.time(),
        "writer": {"hostname": socket.gethostname(), "pid": os.getpid(),
                   **(writer or {})},
        "total_bytes": sum(f["bytes"] for f in files.values()),
        "files": files,
        "leaves": leaves,
    }


def manifest_digest(manifest: dict) -> str:
    """Canonical sha256 of a manifest: the provenance fingerprint a
    serving process reports (/healthz)."""
    blob = json.dumps(manifest, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def manifest_path(step_dir: str) -> str:
    return os.path.join(step_dir, MANIFEST_NAME)


def write_manifest(step_dir: str, manifest: dict) -> str:
    """Atomic commit: tmp + fsync + rename, so a kill mid-write leaves no
    manifest (the epoch then reads as missing-manifest, never as a torn
    manifest that happens to parse)."""
    path = manifest_path(step_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as fp:
        json.dump(manifest, fp, sort_keys=True, indent=1)
        fp.flush()
        os.fsync(fp.fileno())
    os.replace(tmp, path)
    return path


def load_manifest(step_dir: str) -> Optional[dict]:
    path = manifest_path(step_dir)
    if not os.path.exists(path):
        return None
    with open(path) as fp:
        return json.load(fp)


# -- verification -------------------------------------------------------------

def verify_files(step_dir: str) -> Tuple[str, str]:
    """File-level check of one committed epoch against its manifest,
    without deserializing anything: (status, detail), status OK, CORRUPT
    or MISSING_MANIFEST. Catches truncation (size), bit rot (hash), and
    deleted or torn files (missing or unreadable manifest)."""
    if not os.path.isdir(step_dir):
        return CORRUPT, "checkpoint directory missing"
    if not os.path.exists(manifest_path(step_dir)):
        return MISSING_MANIFEST, "no integrity manifest"
    try:
        manifest = load_manifest(step_dir)
    except (OSError, ValueError) as e:
        return CORRUPT, f"unreadable manifest: {e}"
    problems: List[str] = []
    files = manifest.get("files", {})
    for rel, rec in sorted(files.items()):
        path = os.path.join(step_dir, rel.replace("/", os.sep))
        if not os.path.isfile(path):
            problems.append(f"{rel}: missing")
            continue
        size = os.path.getsize(path)
        if size != rec["bytes"]:
            problems.append(f"{rel}: {size} bytes, manifest says "
                            f"{rec['bytes']} (truncated write?)")
            continue
        if file_sha256(path)[1] != rec["sha256"]:
            problems.append(f"{rel}: content hash mismatch (bit rot?)")
    if problems:
        head = "; ".join(problems[:4])
        more = f" (+{len(problems) - 4} more)" if len(problems) > 4 else ""
        return CORRUPT, head + more
    return OK, f"{len(files)} files verified"


def verify_epoch(ckpt_dir: str, epoch: int
                 ) -> Tuple[str, str, Optional[str]]:
    """File-level verdict on one committed epoch: `(status, detail,
    manifest_sha256)`, the digest only when the epoch verifies."""
    step_dir = os.path.join(ckpt_dir, str(epoch))
    status, detail = verify_files(step_dir)
    if status != OK:
        return status, detail, None
    return status, detail, manifest_digest(load_manifest(step_dir))


def verify_leaves(payload, manifest: dict) -> List[str]:
    """Deep check: loaded payload leaves against the manifest's save-time
    hashes, over the keys both have."""
    got = leaf_entries(payload)
    want = manifest.get("leaves", {})
    mismatches: List[str] = []
    for key in sorted(set(got) & set(want)):
        for field in ("shape", "dtype", "sha256", "repr_sha256"):
            if field in want[key] and want[key][field] != got[key].get(field):
                mismatches.append(
                    f"{key}: {field} {got[key].get(field)!r} != manifest "
                    f"{want[key][field]!r}")
                break
    return mismatches


# -- run-dir layout -----------------------------------------------------------

def committed_epochs(ckpt_dir: str) -> List[int]:
    """Ascending committed epochs: a save commits by renaming its
    temporary directory to `<epoch>`, so a pure-digit directory name is
    the commit marker."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.isdir(os.path.join(ckpt_dir, d)))


def quarantined_dirs(ckpt_dir: str) -> List[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith(QUARANTINE_PREFIX)
                  and os.path.isdir(os.path.join(ckpt_dir, d)))


def quarantine_epoch(ckpt_dir: str, epoch: int) -> str:
    """Rename `<epoch>` to `corrupt-<epoch>` (a collision appends `.2`,
    `.3`, ...): the bad bytes stay on disk for forensics, stop shadowing
    older verified generations, and never collide with a later save of the
    same epoch number."""
    src = os.path.join(ckpt_dir, str(epoch))
    dest = os.path.join(ckpt_dir, f"{QUARANTINE_PREFIX}{epoch}")
    n = 1
    while os.path.exists(dest):
        n += 1
        dest = os.path.join(ckpt_dir, f"{QUARANTINE_PREFIX}{epoch}.{n}")
    os.rename(src, dest)
    return dest


def audit(ckpt_dir: str, quarantine: bool = False) -> List[dict]:
    """fsck one checkpoint directory: a record per committed epoch (OK /
    CORRUPT / MISSING_MANIFEST and a detail) and one per quarantined
    directory. With `quarantine=True`, CORRUPT epochs, and missing-manifest
    epochs in a directory whose other epochs carry manifests (an
    interrupted save), are renamed aside; a directory with no manifest
    anywhere (legacy) is only reported."""
    epochs = committed_epochs(ckpt_dir)
    any_manifest = any(
        os.path.exists(manifest_path(os.path.join(ckpt_dir, str(e))))
        for e in epochs)
    records: List[dict] = []
    for epoch in epochs:
        step_dir = os.path.join(ckpt_dir, str(epoch))
        status, detail = verify_files(step_dir)
        rec = {"epoch": epoch, "status": status, "detail": detail}
        if status == OK:
            manifest = load_manifest(step_dir)
            rec["manifest_sha256"] = manifest_digest(manifest)
            rec["total_bytes"] = manifest.get("total_bytes")
            # the saved mesh topology: the port writes none (elastic
            # resharding is not ported), as a pre-elastic JAX manifest
            rec["mesh"] = (manifest.get("sharding") or {}).get("mesh")
        suspect = status == CORRUPT or (status == MISSING_MANIFEST
                                        and any_manifest)
        if quarantine and suspect:
            rec["quarantined_to"] = os.path.basename(
                quarantine_epoch(ckpt_dir, epoch))
            _log(f"fsck: quarantined epoch {epoch} -> "
                 f"{rec['quarantined_to']} ({detail})")
        records.append(rec)
    for d in quarantined_dirs(ckpt_dir):
        records.append({"epoch": None, "status": QUARANTINED, "detail": d})
    return records


def find_checkpoint_dirs(path: str) -> List[str]:
    """Checkpoint directories under `path` for fsck: `path` itself when it
    holds committed (or quarantined) epochs or is named `ckpt`, its
    `ckpt/` child (a run workdir), else every `<child>/ckpt` one level
    down (a runs/ root)."""
    def is_ckpt_dir(p: str) -> bool:
        return bool(committed_epochs(p) or quarantined_dirs(p)
                    or os.path.basename(p.rstrip(os.sep)) == "ckpt")

    if is_ckpt_dir(path):
        return [path]
    child = os.path.join(path, "ckpt")
    if os.path.isdir(child):
        return [child]
    found = []
    for name in sorted(os.listdir(path)):
        sub = os.path.join(path, name, "ckpt")
        if os.path.isdir(sub):
            found.append(sub)
    return found
