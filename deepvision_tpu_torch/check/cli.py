"""The audit's CLI: `python -m deepvision_tpu_torch.check [units...]`
(the counterpart of deepvision_tpu/check/cli.py).

With no positional arguments it sweeps EVERY registered config plus the
epoch, int8 and attention units. Positional arguments name registered
configs, or the pseudo-targets `epoch`, `quant` and `attn`, to audit
alone. The JAX audit's mesh half (the DONATE and COLL checks, the `mesh`
and `spatial` pseudo-targets) waits for the port's mesh (ROADMAP A6) and
is refused by name.

Exit codes (the JAX CLI's):
  0 — clean
  1 — findings reported
  2 — usage error (unknown configs or checks, the mesh half, bad flags)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple

EXIT_CLEAN, EXIT_FINDINGS, EXIT_USAGE = 0, 1, 2

# the port's committed cost baseline, beside the JAX package's
# CHECK_COST.json (which this audit never writes)
DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "CHECK_COST_TORCH.json")

PSEUDO_TARGETS = ("epoch", "quant", "attn")
# the JAX audit's pseudo-targets of the mesh half
MESH_TARGETS = {"mesh": "the mesh-sharded predict units",
                "spatial": "the spatial collective probes"}


def _aliases(requested: List[str]) -> dict:
    """{alias: canonical}: configs equal in everything but their name
    trace once and report under every name."""
    from ..configs import get_config
    canonical, alias_of = {}, {}
    for n in requested:
        key = repr(dataclasses.replace(get_config(n), name="_"))
        if key in canonical:
            alias_of[n] = canonical[key]
        else:
            canonical[key] = n
    return alias_of


def audit(names: Optional[Sequence[str]] = None,
          select: Optional[Sequence[str]] = None,
          baseline_path: Optional[str] = None,
          progress=None) -> Tuple[list, dict]:
    """Audit the named configs and pseudo-targets (default: the whole
    registry and every pseudo-target). Returns (findings, report); the
    report carries the cost table, the units, the skips and the
    aliases."""
    from .harness import build_units, config_names
    from .rules import (Finding, check_cost, check_quant_bytes, cost_of,
                        load_baseline, run_checks)

    names = list(names or [])
    wanted = {t: not names or t in names for t in PSEUDO_TARGETS}
    configs = [n for n in names if n not in PSEUDO_TARGETS]
    requested = configs if names else config_names()
    alias_of = _aliases(requested)
    sweep = [n for n in requested if n not in alias_of]

    selected = {c.upper() for c in select} if select else None
    baseline = None
    if selected is None or "COST" in selected:
        baseline = load_baseline(baseline_path or DEFAULT_BASELINE)
    findings: list = []
    cost_table: dict = {}
    audited: List[str] = []
    skipped: dict = {}
    by_config: dict = {}
    quant_facts: dict = {}
    for unit in build_units(sweep, progress=progress, **wanted):
        audited.append(unit.name)
        if unit.quant is not None:
            quant_facts[unit.name] = dict(unit.quant)
        if unit.skipped:
            skipped[unit.name] = unit.skipped
            continue
        unit_findings = run_checks(unit, select)
        findings.extend(unit_findings)
        cost = cost_of(unit)
        if cost is not None:
            cost_table[unit.name] = cost
        if unit.config_name:
            suffix = unit.name.split("/", 1)[1]
            by_config.setdefault(unit.config_name, []).append(
                (suffix, unit_findings, cost))
        unit.trace = None      # release the op stream before the next
    for alias, canon in alias_of.items():
        for suffix, unit_findings, cost in by_config.get(canon, []):
            uname = f"{alias}/{suffix}"
            audited.append(uname)
            findings.extend(Finding(uname, f.check, f.message, f.severity)
                            for f in unit_findings)
            if cost is not None:
                cost_table[uname] = cost
    if selected is None or "COST" in selected:
        for uname, cost in cost_table.items():
            findings.extend(check_cost(uname, cost, baseline))
    if selected is None or "QUANT" in selected:
        for uname, facts in quant_facts.items():
            findings.extend(check_quant_bytes(uname, facts, cost_table))
    findings.sort(key=lambda f: (f.unit, f.check, f.message))
    report = {"units": audited, "skipped": skipped, "cost": cost_table,
              "aliases": alias_of, "n_units": len(audited)}
    return findings, report


def write_baseline(cost_table: dict, path: str) -> None:
    import torch

    from .harness import AUDIT_BATCH
    payload = {
        "version": 1,
        "audit_batch": AUDIT_BATCH,
        "torch": torch.__version__.split("+")[0],
        "comment": "the port's audit cost per traced step (fake tensors, "
                   "no process group, the batch above): 2*MAC FLOPs in "
                   "the JAX audit's convention, the fusion-blind bytes "
                   "and the op count of the recorded ATen stream. "
                   "Regenerate with `python -m deepvision_tpu_torch.check "
                   "--update-cost` and review the diff like a benchmark.",
        "units": {k: cost_table[k] for k in sorted(cost_table)},
    }
    with open(path, "w") as fp:
        json.dump(payload, fp, indent=1)
        fp.write("\n")


def _summary(findings) -> dict:
    by_check: dict = {}
    for f in findings:
        by_check[f.check] = by_check.get(f.check, 0) + 1
    return by_check


def _render_text(findings, report, dt) -> str:
    lines = [f.format() for f in findings]
    for name, why in sorted(report["skipped"].items()):
        lines.append(f"# skipped {name}: {why}")
    if findings:
        summary = ", ".join(f"{k}: {v}"
                            for k, v in sorted(_summary(findings).items()))
        lines.append(f"audit: {len(findings)} finding"
                     f"{'s' if len(findings) != 1 else ''} ({summary}) "
                     f"over {report['n_units']} units in {dt:.1f}s")
    else:
        lines.append(f"audit: clean ({report['n_units']} units, "
                     f"{len(report['skipped'])} skipped) in {dt:.1f}s")
    return "\n".join(lines)


def _render_json(findings, report, dt) -> str:
    return json.dumps({
        "version": 1,
        "findings": [f.to_json() for f in findings],
        "units": report["units"],
        "cost": report["cost"],
        "skipped": report["skipped"],
        "summary": {"units": report["n_units"],
                    "findings": len(findings),
                    "by_check": _summary(findings),
                    "seconds": round(dt, 1)},
    }, indent=2)


def _render_github(findings, report, dt) -> str:
    lines = []
    for f in findings:
        msg = f.message.replace("%", "%25").replace("\n", "%0A")
        lines.append(f"::error title=audit {f.check} ({f.unit})::{msg}")
    if findings:
        lines.append(f"audit: {len(findings)} finding"
                     f"{'s' if len(findings) != 1 else ''}")
    else:
        lines.append(f"audit: clean ({report['n_units']} units) "
                     f"in {dt:.1f}s")
    return "\n".join(lines)


def _usage(message: str) -> int:
    print(f"usage error: {message}", file=sys.stderr)
    return EXIT_USAGE


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .rules import ALL_CHECKS, MESH_CHECKS

    parser = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch.check",
        description="The port's IR audit: runs each registered config's "
                    "real train, eval and serve steps under fake tensors "
                    "(no data, no FLOPs, CPU-safe) and checks the recorded "
                    "op stream. Checks: " + "; ".join(
                        f"{cid}: {doc}" for cid, doc in ALL_CHECKS.items()))
    parser.add_argument("configs", nargs="*",
                        help="registered configs or the pseudo-targets "
                             f"{', '.join(PSEUDO_TARGETS)} (default: all)")
    parser.add_argument("--format", choices=("text", "json", "github"),
                        default="text",
                        help="github emits ::error workflow annotations")
    parser.add_argument("--select", default=None,
                        help="comma-separated check families (default: "
                             "all)")
    parser.add_argument("--baseline", default=None,
                        help="cost baseline JSON (default: the repo root's "
                             "CHECK_COST_TORCH.json)")
    parser.add_argument("--update-cost", action="store_true",
                        help="rewrite the cost baseline from this sweep "
                             "instead of diffing against it")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="a progress line per config on stderr")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return EXIT_USAGE if e.code not in (0, None) else 0

    select = None
    if args.select:
        select = [c.strip().upper() for c in args.select.split(",")
                  if c.strip()]
        mesh = [c for c in select if c in MESH_CHECKS]
        if mesh:
            return _usage(
                f"{', '.join(mesh)} belong to the JAX audit's mesh half "
                f"({'; '.join(f'{c}: {MESH_CHECKS[c]}' for c in mesh)}), "
                f"which waits for the port's mesh (ROADMAP A6)")
        unknown = [c for c in select if c not in ALL_CHECKS]
        if unknown:
            return _usage(f"unknown check(s): {', '.join(unknown)}; "
                          f"known: {', '.join(ALL_CHECKS)}")

    from ..configs import NOT_PORTED
    from .harness import config_names
    mesh = [n for n in args.configs if n in MESH_TARGETS]
    if mesh:
        return _usage(
            f"{', '.join(mesh)} belong to the JAX audit's mesh half "
            f"({'; '.join(MESH_TARGETS[n] for n in mesh)}), which waits "
            f"for the port's mesh (ROADMAP A6)")
    refused = [n for n in args.configs if n in NOT_PORTED]
    if refused:
        return _usage("; ".join(NOT_PORTED[n] for n in refused))
    known = config_names()
    bad = [n for n in args.configs
           if n not in known and n not in PSEUDO_TARGETS]
    if bad:
        return _usage(f"unknown config(s): {', '.join(bad)}; known: "
                      f"{', '.join(PSEUDO_TARGETS + tuple(known))}")
    if args.update_cost and args.configs:
        return _usage("--update-cost rewrites the whole-registry "
                      "baseline; run it without config arguments")

    progress = ((lambda name: print(f"[audit] {name}", file=sys.stderr,
                                    flush=True))
                if args.verbose else None)
    t0 = time.perf_counter()
    findings, report = audit(args.configs or None, select, args.baseline,
                             progress=progress)
    dt = time.perf_counter() - t0
    if args.update_cost:
        path = args.baseline or DEFAULT_BASELINE
        write_baseline(report["cost"], path)
        findings = [f for f in findings if f.check != "COST"]
        print(f"wrote {len(report['cost'])} cost rows to {path}",
              file=sys.stderr)
    render = {"json": _render_json, "github": _render_github,
              "text": _render_text}[args.format]
    print(render(findings, report, dt))
    return EXIT_FINDINGS if findings else EXIT_CLEAN


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
