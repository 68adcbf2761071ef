"""Calibrated int8 serving behind a hard accuracy gate (port of
deepvision_tpu/serve/quantize.py).

1. **Calibrate.** The family's pinned deterministic shard
   (core/scoring.pinned_shard, the shard promotion's shadow eval uses)
   runs once through the served forward, planned and calibrated by
   ops/quant.py: one activation scale per planned conv or dense call.
2. **Arm.** The engine quantizes each generation from its f32 masters and
   checks the plan at every bucket (`PredictEngine.enable_int8`).
3. **Gate.** The bf16 and int8 rungs score the pinned shard with the
   family's watched metric (core/scoring.score_serving_outputs). int8
   goes live only if `score_int8 - score_bf16 >= -gate`; a regression
   beyond the gate is refused loudly: the engine keeps serving bf16, and
   the decision lands on stderr, the `resilience_` stream
   (`resilience_quant_refused`) and /healthz.

`DEEPVISION_FAULT_QUANT_REGRESS=1` (utils/faults.py) lowers the int8
score by `FAULT_SCORE_DROP`, so the refusal path runs end to end.

A weight generation is re-quantized under the pinned activation scales
(`Quantizer.quantize`, data-free), never recalibrated: hot reload,
promotion and the flywheel's swaps leave `ops/quant.calibrate.passes`
where arming left it.

Byte counts in the decision record: `weight_bytes_bf16` is the f32 master
tree, as the JAX package counts its f32 `variables` under that key;
`weight_bytes_int8` the int8 tree as JAX counts it (int8 weights with f32
scales, every other leaf in f32); `weight_bytes_staged` what the port
stages for its bf16 rung (the compute-dtype cast of each generation).
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from ..core import scoring
from ..core.resilience import log_resilience_event
from ..ops import quant
from ..utils.faults import FaultInjector

# default hard gate: int8 may cost at most 2 points of the watched metric
DEFAULT_GATE = 0.02
DEFAULT_CALIB_EXAMPLES = 64

# the armed DEEPVISION_FAULT_QUANT_REGRESS injector subtracts this from the
# int8 score: large against any sane gate, whatever the weights score
FAULT_SCORE_DROP = 0.5

QUANT_ENABLED = "int8_enabled"
QUANT_REFUSED = "refused_regression"
# the plan itself refused (ops/quant.QuantRefusal): no int8 twin exists,
# the engine keeps serving bf16, and the named reason lands on /healthz
QUANT_REFUSED_PLAN = "refused_plan"


class Quantizer:
    """One engine's quantization state: the calibrated plan of its served
    forward, from which any generation of the same architecture is
    quantized and run at int8.

    `forward` runs `model`'s served forward on the calibration batch; the
    plan is built from it, and calibrated on it, once."""

    def __init__(self, model: torch.nn.Module, forward: Callable[[], Any],
                 head_dims: Iterable[int] = frozenset()):
        self.head_dims = frozenset(head_dims)
        plan = quant.plan_quantization(model, forward, self.head_dims)
        if not plan.ops:
            raise ValueError(
                "nothing to quantize: no conv/dense with a weight operand "
                "outside the f32 heads — int8 serving would be a no-op")
        self.plan = quant.calibrate(plan, model, forward)

    def summary(self) -> dict:
        return self.plan.summary()

    def check_plan(self, model: torch.nn.Module,
                   forward: Callable[[], Any]) -> None:
        """Plan `forward` (one bucket's batch size) again: it must plan the
        same op sequence as calibration, or the scales assigned by
        position would be wrong."""
        plan = quant.plan_quantization(model, forward, self.head_dims)
        if [op.prim for op in plan.ops] != [op.prim for op in self.plan.ops] \
                or plan.params != self.plan.params \
                or plan.heavy_calls != self.plan.heavy_calls:
            raise ValueError(
                f"bucket re-trace planned a different equation set "
                f"({len(plan.ops)} vs {len(self.plan.ops)} at calibration) "
                f"— the predict is not batch-polymorphic; cannot quantize")

    def quantize(self, masters) -> list:
        """One generation's int8 weights from its f32 masters (name ->
        tensor), under the pinned plan."""
        return quant.quantize_weights(self.plan, masters)

    def run(self, forward: Callable[[], Any],
            qweights: Sequence[quant.QWeight]) -> Any:
        """`forward()` at int8 with `qweights`."""
        mode = quant.Int8Mode(self.plan, qweights)
        with mode:
            out = forward()
        mode.check()
        return out


def weight_bytes(engine, plan: quant.QuantPlan) -> dict:
    """The decision record's byte counts of the live generation (module
    docstring)."""
    state = {k: v for k, v in engine.model.state_dict().items()
             if v.is_floating_point()}
    return {"weight_bytes_bf16": 4 * sum(v.numel() for v in state.values()),
            "weight_bytes_int8": quant.int8_state_nbytes(plan, state),
            "weight_bytes_staged": quant.tree_nbytes(state.values())}


def arm_int8(engine, cfg=None, *,
             gate: float = DEFAULT_GATE,
             examples: int = DEFAULT_CALIB_EXAMPLES,
             seed: int = scoring.DEFAULT_SHARD_SEED,
             shard=None,
             logger=None,
             faults: Optional[FaultInjector] = None,
             verbose: bool = True) -> dict:
    """Calibrate, arm and GATE int8 serving for one engine.

    On a gate pass the engine's active precision flips to int8 (bf16
    stays addressable per request); on a regression beyond `gate` the
    engine is left serving bf16, with the refusal on stderr and the
    `resilience_` stream. Returns the decision record (also
    `engine.quant_decision`, reported on /healthz). A family without a
    watch metric, or a plan with nothing to quantize, raises ValueError."""
    from ..configs import get_config
    cfg = cfg or get_config(engine.name)
    if cfg.family not in scoring.GATED_FAMILIES:
        raise ValueError(
            f"config {cfg.name!r} (family {cfg.family!r}) has no "
            f"predict-side watch metric to gate int8 against — gated "
            f"families: {scoring.GATED_FAMILIES}")
    faults = faults if faults is not None else FaultInjector.from_env()
    t0 = time.monotonic()
    images, targets = shard if shard is not None else scoring.pinned_shard(
        cfg, image_size=engine.example_shape[0],
        input_dtype=engine.input_dtype, examples=examples, seed=seed)
    watch = scoring.watch_metric_name(cfg)
    model = engine.model

    def calibration_forward():
        with torch.inference_mode():
            return engine.forward(model, np.asarray(images))

    try:
        quantizer = Quantizer(model, calibration_forward,
                              head_dims=scoring.serving_head_dims(cfg))
    except quant.QuantRefusal as exc:
        # the plan refused by name: the engine is untouched, serving bf16
        decision = {
            "decision": QUANT_REFUSED_PLAN,
            "reason": exc.reason,
            "detail": str(exc),
            "watch": watch,
            "secs": round(time.monotonic() - t0, 3),
            "unix": time.time(),
        }
        engine.quant_decision = decision
        log_resilience_event(logger, 1, {"quant_refused": 1.0})
        print(f"[serve-quant:{engine.name}] {QUANT_REFUSED_PLAN} "
              f"({exc.reason}): {exc} — serving bf16",
              file=sys.stderr, flush=True)
        return decision
    engine.enable_int8(quantizer, verbose=verbose)

    # the hard gate: identical pinned inputs, two precisions
    metric_bf16 = scoring.score_serving_outputs(
        cfg, engine.predict(images, precision="bf16"), targets)
    metric_int8 = scoring.score_serving_outputs(
        cfg, engine.predict(images, precision="int8"), targets)
    if faults.quant_regression():
        metric_int8 = max(0.0, metric_int8 - FAULT_SCORE_DROP)
    delta = metric_int8 - metric_bf16
    passed = delta >= -abs(gate)
    decision = {
        "decision": QUANT_ENABLED if passed else QUANT_REFUSED,
        "watch": watch,
        "metric_bf16": round(metric_bf16, 4),
        "metric_int8": round(metric_int8, 4),
        "delta": round(delta, 4),
        "gate": abs(gate),
        "calibration_examples": int(np.shape(images)[0]),
        "quantized_eqns": quantizer.summary()["quantized"],
        # the whole plan split: a ViT's attention stays in float on K1
        # (fused_attention), named on /healthz
        "plan": quantizer.summary(),
        **weight_bytes(engine, quantizer.plan),
        "secs": round(time.monotonic() - t0, 3),
        "unix": time.time(),
    }
    if passed:
        engine.set_precision("int8")
        log_resilience_event(logger, 1, {
            "quant_enabled": 1.0, "quant_delta": float(delta)})
    else:
        engine.disable_int8()
        log_resilience_event(logger, 1, {
            "quant_refused": 1.0, "quant_delta": float(delta)})
    engine.quant_decision = decision
    print(f"[serve-quant:{engine.name}] {decision['decision']}: "
          f"{watch} bf16 {metric_bf16:.4f} vs int8 {metric_int8:.4f} "
          f"(delta {delta:+.4f}, gate -{abs(gate):g}) — "
          + (f"int8 live, weights "
             f"{decision['weight_bytes_bf16'] / 1e6:.1f}MB -> "
             f"{decision['weight_bytes_int8'] / 1e6:.1f}MB"
             if passed else "REFUSED, serving bf16"),
          file=sys.stderr, flush=True)
    return decision
