"""`python -m deepvision_tpu_torch <subcommand>`: the port's maintenance CLI
(own copy of deepvision_tpu/__main__.py).

    # audit the checkpoint integrity of a run directory (or a runs/ root)
    python -m deepvision_tpu_torch fsck runs/yolov3
    python -m deepvision_tpu_torch fsck runs/yolov3 --quarantine   # repair

fsck walks every checkpoint directory under the path (the path itself when
it holds committed epochs, its `ckpt/` child for a run workdir, else every
`<child>/ckpt` one level down) and prints one line per epoch:

    OK                epoch 3   1.2 MB  manifest=ab12cd34ef56
    CORRUPT           epoch 2   state.pt: content hash mismatch (bit rot?)
    MISSING-MANIFEST  epoch 1   no integrity manifest
    QUARANTINED                 corrupt-2

Exit codes: 0 = nothing corrupt, 1 = at least one CORRUPT epoch (even when
`--quarantine` just repaired it: rerun for a clean 0), 2 = usage error
(the path is not a directory). `--quarantine` renames corrupt epochs (and
missing-manifest epochs in directories whose siblings carry manifests: an
interrupted save) to `corrupt-<epoch>/`, so restores stop considering
them. `--format json` prints one JSON document (the summary and the full
per-epoch reports, no human lines) with the same exit codes; `--json`
appends the reports to the text mode's summary line. The output, the
summary keys and the exit codes are the JAX package's.

The audit is file-level (sizes and sha256 against the manifest): it loads
no checkpoint and starts no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


def _human_bytes(n) -> str:
    if n is None:
        return "?"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024.0
    return f"{n:.1f} TB"


def _fmt_mesh(mesh) -> str:
    """'data:4,model:2' of a manifest's saved mesh (size-1 axes elided);
    '' when the manifest has none, as the port's never do."""
    axes = (mesh or {}).get("axes") or {}
    shown = {k: v for k, v in axes.items() if v > 1} or axes
    return ",".join(f"{k}:{v}" for k, v in shown.items())


def fsck_summary(path: str, quarantine: bool = False) -> tuple:
    """(exit code, summary) of auditing every checkpoint directory under
    `path`, the summary with its per-epoch `reports`: what `fsck --format
    json` prints, for callers in-process. Prints nothing."""
    from .core import integrity
    ckpt_dirs = integrity.find_checkpoint_dirs(os.path.abspath(path))
    reports = [{"dir": d, "epochs": integrity.audit(d, quarantine=quarantine)}
               for d in ckpt_dirs]
    n_corrupt = sum(r["status"] == integrity.CORRUPT
                    for d in reports for r in d["epochs"])
    summary = {"fsck": "corrupt" if n_corrupt else "ok",
               "checkpoint_dirs": len(ckpt_dirs),
               "epochs_audited": sum(1 for d in reports for r in d["epochs"]
                                     if r["epoch"] is not None),
               "corrupt": n_corrupt,
               "quarantined": quarantine and n_corrupt > 0,
               "reports": reports}
    return (1 if n_corrupt else 0), summary


def _cmd_fsck(args: argparse.Namespace) -> int:
    from .core import integrity

    machine = args.format == "json"
    path = os.path.abspath(args.path)
    if not os.path.isdir(path):
        print(f"fsck: {args.path!r} is not a directory", file=sys.stderr)
        return 2
    rc, summary = fsck_summary(path, args.quarantine)
    if not summary["checkpoint_dirs"] and not machine:
        print(f"fsck: no checkpoint directories under {args.path} "
              f"(nothing to audit)")
        return 0
    for entry in summary["reports"]:
        d, records = entry["dir"], entry["epochs"]
        if machine:
            continue
        print(f"== {d}")
        if not records:
            print("   (no committed epochs)")
        for r in records:
            status = r["status"].upper().replace("_", "-")
            if r["status"] == integrity.OK:
                detail = (f"{_human_bytes(r.get('total_bytes'))}  "
                          f"manifest={r.get('manifest_sha256', '')[:12]}")
                mesh = _fmt_mesh(r.get("mesh"))
                if mesh:
                    detail += f"  mesh={mesh}"
            else:
                detail = r["detail"]
                if "quarantined_to" in r:
                    detail += f" -> {r['quarantined_to']}"
            epoch = f"epoch {r['epoch']}" if r["epoch"] is not None else ""
            print(f"{status:17s} {epoch:9s} {detail}")
    if not (machine or args.json):
        del summary["reports"]
    print(json.dumps(summary))
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch",
        description="Maintenance subcommands of the PyTorch port (see "
                    "also: -m deepvision_tpu_torch.serve)")
    sub = parser.add_subparsers(dest="command", required=True)
    fsck = sub.add_parser(
        "fsck", help="audit checkpoint integrity across a run directory",
        description="Verify every committed checkpoint epoch against its "
                    "integrity manifest (file sizes + sha256). Exit 0 = "
                    "clean, 1 = corruption found, 2 = usage error.")
    fsck.add_argument("path", help="run workdir, its ckpt/ dir, or a runs/ "
                                   "root to scan one level deep")
    fsck.add_argument("--quarantine", action="store_true",
                      help="rename corrupt epochs to corrupt-<epoch>/ so "
                           "restores stop considering them (repair)")
    fsck.add_argument("--json", action="store_true",
                      help="append full per-epoch reports to the summary "
                           "JSON line (text mode; see also --format json)")
    fsck.add_argument("--format", choices=["text", "json"], default="text",
                      help="'json' emits one machine-readable document "
                           "(summary + per-epoch reports) and no human "
                           "lines; exit codes unchanged (0/1/2)")
    fsck.set_defaults(fn=_cmd_fsck)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
