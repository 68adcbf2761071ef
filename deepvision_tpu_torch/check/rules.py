"""The audit's check families over traced units (the counterpart of
deepvision_tpu/check/rules.py).

Each check reads what check/walk.py recorded of a unit's REAL step and
compares it with the claim the step's factory attached
(`core/steps.annotate_step`), so what is verified is exactly what the
construction site declared. DONATE and COLL have no counterpart yet: a
PyTorch step updates its state in place (nothing is donated), and the
mesh they audit is ROADMAP A6; the CLI refuses them by name.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import torch

from .harness import TracedUnit

ALL_CHECKS: Dict[str, str] = {
    "DTYPE": "no f32 conv or product op inside a declared-bf16 step outside "
             "the deliberate f32 heads; f32 steps must not drop to bf16; "
             "predict outputs are f32",
    "COST": "per-step FLOPs / bytes / op count from the recorded op "
            "stream, diffed against the committed CHECK_COST_TORCH.json",
    "SERVE": "the PredictEngine's default buckets {1, 8, 32, max_batch} "
             "cover each servable config's input spec, outputs keep the "
             "batch dim",
    "QUANT": "the int8 serving twins run their planned convs and dense "
             "layers as int8 x int8 -> int32 products, and their weight "
             "bytes undercut the serve row's by >= 1.8x",
    "TRACE": "every registered (config, model, step-factory) combination "
             "builds and runs under fake tensors at all",
}

# checks of the JAX audit that wait for the port's mesh (ROADMAP A6)
MESH_CHECKS: Dict[str, str] = {
    "DONATE": "buffer donation is an XLA contract; a PyTorch step updates "
              "its state in place",
    "COLL": "the collectives it audits are the spatial and model axes of "
            "the mesh",
}

# COST drift tolerances (relative). FLOPs from shapes are exact, so any
# drift is a real model or step change; bytes and the op count may move a
# little with the PyTorch release's decompositions.
COST_TOLERANCE = {"flops": 1e-6, "bytes": 0.01, "eqns": 0.05,
                  "param_bytes": 1e-6}

# the int8 twins' byte bar: weight bytes must undercut the serve row's
# (the f32 masters, 4 bytes a weight) by at least this factor
QUANT_PARAM_BYTES_FACTOR = 1.8


@dataclasses.dataclass
class Finding:
    unit: str
    check: str
    message: str
    severity: str = "error"

    def format(self) -> str:
        return f"{self.unit}: {self.check} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _float_outputs_not_f32(unit: TracedUnit) -> List[Finding]:
    return [Finding(unit.name, "DTYPE",
                    f"float output {list(shape)} is {dtype}, not float32 — "
                    f"predict outputs must be f32 (the engine's contract, "
                    f"serve/engine.py)")
            for shape, dtype in unit.out_specs
            if dtype.is_floating_point and dtype != torch.float32]


def check_dtype(unit: TracedUnit) -> List[Finding]:
    findings: List[Finding] = []
    policy = unit.meta.get("compute_dtype")
    if unit.meta.get("kind") == "predict" or unit.kind == "predict":
        findings.extend(_float_outputs_not_f32(unit))
    if unit.trace is None:
        return findings
    if "kind" not in unit.meta:
        return findings + [Finding(
            unit.name, "DTYPE",
            "step carries no claim (its factory did not annotate it "
            "through core/steps.py::annotate_step) — the audit cannot hold "
            "it to its declared compute dtype")]
    if policy is None:
        return findings
    for op in unit.trace.products():
        if op.in_kernel:
            # K1's and K2's nodes: their tiles stay in the kernel's own
            # precision (K1 accumulates its softmax in f32 on purpose)
            continue
        floats = [dt for dt in op.operands if dt.is_floating_point]
        if policy == torch.bfloat16 and op.out_dtype == torch.float32 \
                and torch.float32 in floats:
            # a bf16-operand product that accumulates in f32 is the policy;
            # only an f32 operand betrays f32 data in the step
            if unit.head_dims & op.dims:
                continue  # a deliberate f32 head (models/*.py dtype=f32)
            findings.append(Finding(
                unit.name, "DTYPE",
                f"f32 {op.name} {op.shape} inside a declared-bfloat16 step "
                f"(head dims {sorted(unit.head_dims)} not involved) — an "
                f"f32 leak into the compute path"))
        elif policy == torch.float32 and op.out_dtype == torch.bfloat16:
            findings.append(Finding(
                unit.name, "DTYPE",
                f"bf16 {op.name} {op.shape} inside a declared-float32 "
                f"step — compute silently below the config's precision"))
    return findings


def check_serve(unit: TracedUnit) -> List[Finding]:
    if unit.serve is None:
        return []
    findings: List[Finding] = []
    s = unit.serve
    buckets, max_batch = list(s["buckets"]), s["max_batch"]
    if buckets != sorted(set(buckets)) or any(b <= 0 for b in buckets):
        findings.append(Finding(
            unit.name, "SERVE",
            f"bucket signature {buckets} is not strictly ascending "
            f"positive — pick_bucket's search contract"))
    if 1 not in buckets:
        findings.append(Finding(
            unit.name, "SERVE",
            f"bucket signature {buckets} lacks the batch-of-1 bucket — "
            f"single-example requests would pad to {buckets[0]}x"))
    if max_batch < buckets[-1]:
        findings.append(Finding(
            unit.name, "SERVE",
            f"max_batch {max_batch} < largest bucket {buckets[-1]} — the "
            f"batcher would flush batches no bucket takes"))
    for bkt, outs in s["probe_outs"].items():
        for shape, _ in outs:
            if shape and shape[0] != bkt:
                findings.append(Finding(
                    unit.name, "SERVE",
                    f"predict output {shape} at bucket {bkt} does not keep "
                    f"the batch dim — per-row slicing after a padded "
                    f"dispatch would return wrong rows"))
    return findings


def check_quant(unit: TracedUnit) -> List[Finding]:
    """The int8 twin runs int8 where the plan claims: every planned conv
    and dense layer is an int8 x int8 product accumulated in int32
    (`aten._int_mm`, or a depthwise int32 tap sum), and every float
    product left is a head's or within the plan's attention budget. K1's
    node is the plan's `fused_attention`, not a float product."""
    if unit.quant is None or unit.trace is None:
        return []
    findings: List[Finding] = []
    planned = int(unit.quant.get("planned", 0))
    budget = int(unit.quant.get("skipped_attention", 0))
    n_int8, floats = 0, []
    for op in unit.trace.products():
        if op.in_kernel:
            continue
        if op.kind in ("int_mm", "depthwise"):
            if op.out_dtype != torch.int32:
                findings.append(Finding(
                    unit.name, "QUANT",
                    f"int8 {op.name} accumulates in {op.out_dtype}, not "
                    f"int32 — partial products past 127^2 x taps would "
                    f"wrap"))
            n_int8 += 1
            continue
        if any(dt.is_floating_point for dt in op.operands) \
                and not unit.head_dims & op.dims:
            floats.append(op)
    for op in floats[budget:]:
        findings.append(Finding(
            unit.name, "QUANT",
            f"claimed-int8 predict carries a float {op.name} {op.shape} "
            f"({op.operands[0]}) outside the f32 heads and beyond the "
            f"plan's attention budget ({budget}) — the quantized path "
            f"widened back to float"))
    fused = int(unit.quant.get("fused_attention", 0))
    k1 = sum(op.kind == "flash_attention" for op in unit.trace.products())
    if k1 != fused:
        findings.append(Finding(
            unit.name, "QUANT",
            f"plan counts {fused} fused-attention calls but the trace holds "
            f"{k1} K1 nodes"))
    if n_int8 < planned:
        findings.append(Finding(
            unit.name, "QUANT",
            f"plan claims {planned} int8 products but the trace carries "
            f"{n_int8} — quantization quietly skipped {planned - n_int8} "
            f"of them"))
    return findings


def check_quant_bytes(unit_name: str, quant_facts: dict,
                      cost_table: dict) -> List[Finding]:
    """The byte bar, once both rows exist: the int8 twin's weight bytes
    undercut its serve row's (`<config>/serve`) by
    QUANT_PARAM_BYTES_FACTOR."""
    base_name = quant_facts.get("baseline_unit")
    mine = cost_table.get(unit_name, {}).get("param_bytes")
    theirs = cost_table.get(base_name, {}).get("param_bytes")
    if mine is None or theirs is None:
        return []
    if mine * QUANT_PARAM_BYTES_FACTOR > theirs:
        return [Finding(
            unit_name, "QUANT",
            f"int8 weight bytes {mine} vs serve row {base_name} {theirs} — "
            f"cut is only {theirs / max(mine, 1):.2f}x, below the "
            f"{QUANT_PARAM_BYTES_FACTOR:g}x bar (did quantization skip "
            f"the heavy layers?)")]
    return []


def check_trace(unit: TracedUnit) -> List[Finding]:
    if unit.error:
        return [Finding(unit.name, "TRACE",
                        f"unit failed to build/trace: {unit.error}")]
    return []


def cost_of(unit: TracedUnit) -> Optional[dict]:
    if unit.trace is None:
        return None
    cost = unit.trace.cost()
    if unit.param_bytes is not None:
        cost["param_bytes"] = int(unit.param_bytes)
    return cost


def check_cost(unit_name: str, cost: dict,
               baseline_units: Optional[dict],
               baseline_name: str = "CHECK_COST_TORCH.json") -> List[Finding]:
    """One unit's cost row against the committed baseline (None: no file,
    or an --update-cost run, and nothing to diff)."""
    if baseline_units is None:
        return []
    base = baseline_units.get(unit_name)
    if base is None:
        return [Finding(
            unit_name, "COST",
            f"no baseline row in {baseline_name} — run `python -m "
            f"deepvision_tpu_torch.check --update-cost` and commit the "
            f"diff")]
    findings: List[Finding] = []
    for field, tol in COST_TOLERANCE.items():
        want, got = base.get(field), cost.get(field)
        if want is None or got is None:
            continue
        denom = max(abs(want), 1)
        if abs(got - want) / denom > tol:
            findings.append(Finding(
                unit_name, "COST",
                f"{field} drifted {want} -> {got} "
                f"({(got - want) / denom:+.2%}, tolerance {tol:.0%}) — if "
                f"intended, refresh the baseline with --update-cost and "
                f"put the diff in the PR"))
    return findings


def load_baseline(path: str) -> Optional[dict]:
    try:
        with open(path) as fp:
            data = json.load(fp)
    except (OSError, ValueError):
        return None
    return data.get("units", {})


def run_checks(unit: TracedUnit, select=None) -> List[Finding]:
    """Every family but COST over one unit (COST needs the baseline and
    runs in the sweep)."""
    wanted = {c.upper() for c in select} if select else None

    def on(check):
        return wanted is None or check in wanted

    out: List[Finding] = []
    if on("TRACE"):
        out.extend(check_trace(unit))
    if unit.error:
        return out
    if on("DTYPE"):
        out.extend(check_dtype(unit))
    if on("SERVE"):
        out.extend(check_serve(unit))
    if on("QUANT"):
        out.extend(check_quant(unit))
    return out
