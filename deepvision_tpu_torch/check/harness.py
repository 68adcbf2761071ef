"""Audit units: the real steps of every registered config, traced with no
data (the counterpart of deepvision_tpu/check/harness.py).

For each registered config this module builds the state a trainer would
build and runs the REAL factory-built step once (core/steps.py,
core/detection.py, core/pose.py, core/centernet.py, core/segment.py,
core/gan.py) with its backward and its optimizer update, under a
`FakeTensorMode` with check/walk.py's `Recorder` on top: every tensor
carries a shape and a dtype and no storage, so a whole-registry sweep
runs on the CPU with no data, no FLOPs and no device memory.

How the state is made fake: the port's weight inits draw from data
(`trunc_normal_` with a generator), which fake tensors cannot run, so
the model is constructed on the `meta` device (no init runs on data),
and each parameter and buffer is then replaced by a fake CPU tensor of
its shape and dtype. The optimizer, the EMA and the train state are
built from those fake parameters, so `loss.backward()` and
`Optimizer.step()` run in place on fake state.

Determinism: every unit runs at the fixed `AUDIT_BATCH`, with no process
group, so the op stream (and the COST table) depends only on the
package source and the PyTorch release, not on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import (FakeTensorMode,
                                           unset_fake_temporarily)
from torch.utils._pytree import tree_flatten

from .walk import Recorder, Trace, param_bytes

# One fixed batch for every unit: the cost does not depend on what the
# data is, and a fixed batch keeps the baseline comparable across configs
# and hosts (a config's batch_size is a launch parameter, not a property
# of the step).
AUDIT_BATCH = 8

# the epoch units (core/steps.py::make_epoch_train_step) over one
# classification, one segmentation and one transformer inner step, at a
# fixed length: their rows scale linearly with it
EPOCH_UNIT_CONFIGS = ("lenet5", "unet_synthetic", "vit_tiny")
EPOCH_LENGTH = 4

# the int8 serving twins (ops/quant.py): the tiny f32 config, the
# bandwidth-bound CNN and the transformer whose attention stays on K1
QUANT_UNIT_CONFIGS = ("lenet5", "resnet50", "vit_tiny")

# the ViT serve forward under both attention lowerings, at 112 px: with
# patch 8 that is 14 x 14 + cls = 197 tokens, the regime K1 serves
ATTN_UNIT_CONFIG = "vit_tiny"
ATTN_IMPLS = ("naive", "fused")
ATTN_AUDIT_IMAGE = 112


@dataclasses.dataclass
class TracedUnit:
    """One audited step: what it ran, and the factory's own claim."""
    name: str                      # "resnet50/train"
    config_name: str               # registry key ("" for epoch/quant/attn)
    kind: str                      # train | eval | predict
    trace: Optional[Trace] = None  # None for the output-only predict units
    out_specs: list = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)   # the claim
    head_dims: frozenset = frozenset()  # dims of the deliberate f32 heads
    serve: Optional[dict] = None   # SERVE: bucket coverage facts
    quant: Optional[dict] = None   # QUANT: the int8 twin's plan facts
    param_bytes: Optional[int] = None
    skipped: Optional[str] = None
    error: Optional[str] = None


def _specs(out) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    return [(tuple(t.shape), t.dtype) for t in tree_flatten(out)[0]
            if isinstance(t, torch.Tensor)]


_FAKE_MODE: Optional[FakeTensorMode] = None


@contextlib.contextmanager
def fake_tensors() -> Iterator[FakeTensorMode]:
    """The mode every unit traces in: tensors with shapes, no storage.
    A real module-level constant a step reads (YOLO's anchors) becomes a
    fake tensor of this mode when an op meets it; one mode serves the
    process, so the converted constant belongs to it in every unit."""
    global _FAKE_MODE
    if _FAKE_MODE is None:
        _FAKE_MODE = FakeTensorMode(allow_non_fake_inputs=True)
    with _FAKE_MODE:
        yield _FAKE_MODE


def record(fn: Callable, *args) -> Tuple[Trace, object]:
    """(what `fn(*args)` ran, its result)."""
    rec = Recorder()
    with rec:
        out = fn(*args)
    return rec.trace, out


def meta_module(build: Callable[[], torch.nn.Module]) -> torch.nn.Module:
    """`build()` constructed on the `meta` device, outside any fake mode:
    shapes, no init."""
    with unset_fake_temporarily(), torch.device("meta"):
        return build()


def fakify(module: torch.nn.Module) -> torch.nn.Module:
    """Each parameter and buffer of a meta `module` replaced by a fake
    CPU tensor of its shape and dtype (call under `fake_tensors()`)."""
    return module._apply(lambda t: torch.empty(t.shape, dtype=t.dtype))


def pin_trace_impls(cfg):
    """A config whose `attention_impl` is "auto" traced with the naive
    lowering, as the JAX audit pins it: the config rows stay the plain
    lowering's, and the fused one has its own rows (the attn units)."""
    if cfg.model_kwargs.get("attention_impl") == "auto":
        cfg = cfg.replace(model_kwargs={**cfg.model_kwargs,
                                        "attention_impl": "naive"})
    return cfg


def head_dims(cfg) -> frozenset:
    """The dims of a config's deliberate f32 heads: one definition shared
    with the int8 plan (`core/scoring.serving_head_dims`), so what DTYPE
    exempts as a head is what the quantizer keeps in float."""
    from ..core.scoring import serving_head_dims
    return serving_head_dims(cfg)


def _input_norm(cfg):
    return ((cfg.data.mean, cfg.data.std) if cfg.data.normalize_on_device
            else None)


def _images(cfg, batch: int = AUDIT_BATCH, lead: Tuple[int, ...] = ()):
    """The host pipeline's batch: uint8 pixels when the step normalizes on
    the device, else f32."""
    sz, ch = cfg.data.image_size, cfg.data.channels
    dtype = torch.uint8 if cfg.data.normalize_on_device else torch.float32
    return torch.empty((*lead, batch, sz, sz, ch), dtype=dtype)


def _steps_per_epoch(cfg) -> int:
    return max(1, cfg.data.train_examples // cfg.batch_size)


def _state(model: torch.nn.Module, cfg, ema: bool = False):
    """The TrainState a trainer builds, on fake parameters."""
    from ..core.optim import build_optimizer
    from ..core.train_state import TrainState
    optimizer = build_optimizer(model.parameters(), cfg.optimizer,
                                cfg.schedule, _steps_per_epoch(cfg),
                                cfg.total_epochs)
    return TrainState(model, optimizer, seed=cfg.seed,
                      ema_decay=cfg.ema_decay if ema else None,
                      remat=cfg.remat)


def _model(cfg) -> torch.nn.Module:
    from ..models import build_model
    return fakify(meta_module(lambda: build_model(cfg)))


def _claim(step) -> dict:
    return dict(getattr(step, "audit_claim", {}))


def _traced(name, cname, kind, step, args, head, run=None) -> TracedUnit:
    """Run `step(*args)` (or `run(step, *args)`) under the recorder."""
    trace, out = record(run or step, *((step,) if run else ()), *args)
    return TracedUnit(name, cname, kind, trace, _specs(out), _claim(step),
                      head_dims=head)


def _outputs_only(name, cname, step, args, head) -> TracedUnit:
    """A predict step run for its output specs alone (JAX: eval_shape)."""
    out = step(*args)
    return TracedUnit(name, cname, "predict", out_specs=_specs(out),
                      meta=_claim(step), head_dims=head)


# -- per-family unit builders -------------------------------------------------

def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _classification_units(name, cfg) -> List[TracedUnit]:
    from ..core import steps as steps_lib

    cfg = pin_trace_impls(cfg)
    state = _state(_model(cfg), cfg, ema=bool(cfg.ema_decay))
    images = _images(cfg)
    labels = torch.empty((AUDIT_BATCH,), dtype=torch.int64)
    head, norm = head_dims(cfg), _input_norm(cfg)
    step = steps_lib.make_classification_train_step(
        label_smoothing=cfg.label_smoothing, aux_weight=cfg.aux_loss_weight,
        compute_dtype=_dtype(cfg), input_norm=norm,
        mixup_alpha=cfg.mixup_alpha, cutmix_alpha=cfg.cutmix_alpha,
        log_grad_norm=cfg.log_grad_norm)
    units = [_traced(f"{name}/train", name, "train", step,
                     (state, (images, labels)), head,
                     run=steps_lib.step_and_ema)]
    estep = steps_lib.make_classification_eval_step(
        compute_dtype=_dtype(cfg), input_norm=norm)
    mask = torch.empty((AUDIT_BATCH,), dtype=torch.float32)
    units.append(_traced(f"{name}/eval", name, "eval", estep,
                         (state, images, labels, mask), head))
    return units


def _box_targets():
    from ..ops.yolo import MAX_BOXES
    b = AUDIT_BATCH
    return (torch.empty((b, MAX_BOXES, 4), dtype=torch.float32),
            torch.empty((b, MAX_BOXES), dtype=torch.int32),
            torch.empty((b, MAX_BOXES), dtype=torch.float32))


def _detection_units(name, cfg) -> List[TracedUnit]:
    from ..core import detection as det

    state = _state(_model(cfg), cfg)
    images, targets = _images(cfg), _box_targets()
    head = head_dims(cfg)
    kw = dict(num_classes=cfg.data.num_classes,
              grid_sizes=det.yolo_grid_sizes(cfg.data.image_size),
              compute_dtype=_dtype(cfg), input_norm=_input_norm(cfg))
    step = det.make_yolo_train_step(**kw, log_grad_norm=cfg.log_grad_norm)
    units = [_traced(f"{name}/train", name, "train", step,
                     (state, images, *targets), head)]
    estep = det.make_yolo_eval_step(**kw)
    units.append(_traced(f"{name}/eval", name, "eval", estep,
                         (state, images, *targets), head))
    pstep = det.make_predict_step(compute_dtype=_dtype(cfg))
    units.append(_outputs_only(f"{name}/predict", name, pstep,
                               (state, _images(cfg).float()), head))
    return units


def _pose_units(name, cfg) -> List[TracedUnit]:
    from ..core import pose as pose_lib

    state = _state(_model(cfg), cfg)
    images = _images(cfg)
    kp = torch.empty((AUDIT_BATCH, cfg.data.num_classes),
                     dtype=torch.float32)
    head = head_dims(cfg)
    hm = (cfg.data.image_size // 4, cfg.data.image_size // 4)
    kw = dict(heatmap_size=hm, compute_dtype=_dtype(cfg),
              input_norm=_input_norm(cfg))
    step = pose_lib.make_pose_train_step(**kw,
                                         log_grad_norm=cfg.log_grad_norm)
    units = [_traced(f"{name}/train", name, "train", step,
                     (state, images, kp, kp, kp), head)]
    estep = pose_lib.make_pose_eval_step(**kw)
    units.append(_traced(f"{name}/eval", name, "eval", estep,
                         (state, images, kp, kp, kp), head))
    return units


def _centernet_units(name, cfg) -> List[TracedUnit]:
    from ..core import centernet as cn

    state = _state(_model(cfg), cfg)
    images, targets = _images(cfg), _box_targets()
    head = head_dims(cfg)
    kw = dict(num_classes=cfg.data.num_classes,
              grid=cfg.data.image_size // 4, compute_dtype=_dtype(cfg),
              input_norm=_input_norm(cfg))
    step = cn.make_centernet_train_step(**kw,
                                        log_grad_norm=cfg.log_grad_norm)
    units = [_traced(f"{name}/train", name, "train", step,
                     (state, images, *targets), head)]
    estep = cn.make_centernet_eval_step(**kw)
    units.append(_traced(f"{name}/eval", name, "eval", estep,
                         (state, images, *targets), head))
    pstep = cn.make_centernet_predict_step(compute_dtype=_dtype(cfg))
    units.append(_outputs_only(f"{name}/predict", name, pstep,
                               (state, _images(cfg).float()), head))
    return units


def _segmentation_units(name, cfg) -> List[TracedUnit]:
    from ..core import segment as seg_lib

    state = _state(_model(cfg), cfg)
    images = _images(cfg)
    sz = cfg.data.image_size
    masks = torch.empty((AUDIT_BATCH, sz, sz), dtype=torch.int64)
    head, norm = head_dims(cfg), _input_norm(cfg)
    dice = seg_lib.dice_weight_for(cfg)
    step = seg_lib.make_segmentation_train_step(
        compute_dtype=_dtype(cfg), input_norm=norm, dice_weight=dice,
        log_grad_norm=cfg.log_grad_norm)
    units = [_traced(f"{name}/train", name, "train", step,
                     (state, images, masks), head)]
    estep = seg_lib.make_segmentation_eval_step(
        num_classes=cfg.data.num_classes, compute_dtype=_dtype(cfg),
        input_norm=norm, dice_weight=dice)
    units.append(_traced(f"{name}/eval", name, "eval", estep,
                         (state, images, masks), head))
    pstep = seg_lib.make_segmentation_predict_step(
        compute_dtype=_dtype(cfg), input_norm=norm)
    units.append(_outputs_only(f"{name}/predict", name, pstep,
                               (state, images), head))
    return units


def _gan_units(name, cfg) -> List[TracedUnit]:
    from ..core import gan as gan_lib
    from ..models.gan import (CycleGANGenerator, DCGANDiscriminator,
                              DCGANGenerator, PatchGANDiscriminator)

    b, sz, ch = AUDIT_BATCH, cfg.data.image_size, cfg.data.channels
    if cfg.model == "dcgan":
        noise_dim = 100
        gen = fakify(meta_module(lambda: DCGANGenerator(noise_dim)))
        disc = fakify(meta_module(DCGANDiscriminator))
        step = gan_lib.make_dcgan_train_step(noise_dim)
        images = torch.empty((b, sz, sz, ch), dtype=torch.float32)
        return [_traced(f"{name}/train", name, "train", step,
                        (_state(gen, cfg), _state(disc, cfg), images), ())]
    gens = fakify(meta_module(lambda: torch.nn.ModuleDict({
        k: CycleGANGenerator(9) for k in ("a2b", "b2a")})))
    discs = fakify(meta_module(lambda: torch.nn.ModuleDict({
        k: PatchGANDiscriminator() for k in ("a", "b")})))
    gen_state, disc_state = _state(gens, cfg), _state(discs, cfg)
    real = torch.empty((b, sz, sz, 3), dtype=torch.float32)
    gstep = gan_lib.make_cyclegan_generator_step()
    dstep = gan_lib.make_cyclegan_discriminator_step()
    return [_traced(f"{name}/train_gen", name, "train", gstep,
                    (gen_state, disc_state, real, real), ()),
            _traced(f"{name}/train_disc", name, "train", dstep,
                    (disc_state, real, real, real, real), ())]


# -- the serve forward --------------------------------------------------------

def engine_buckets() -> Tuple[Tuple[int, ...], int]:
    """(buckets, max_batch) of a PredictEngine built with its defaults."""
    from ..serve.engine import PredictEngine
    params = inspect.signature(PredictEngine.__init__).parameters
    buckets = tuple(sorted(params["buckets"].default))
    max_batch = params["max_batch"].default or buckets[-1]
    return buckets, max_batch


def served_model(cfg) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """(the module as the engine stages it, the f32 state it was staged
    from): eval mode, the compute weights cast once
    (`cast_compute_weights_`, applied on the meta module: a fake
    parameter cannot be cast in place)."""
    from ..models import build_model
    meta = meta_module(lambda: build_model(cfg))
    with unset_fake_temporarily():
        shapes = {k: (v.shape, v.dtype) for k, v in meta.state_dict().items()}
        meta.eval().cast_compute_weights_()
    masters = {k: torch.empty(shape, dtype=dtype)
               for k, (shape, dtype) in shapes.items()}
    return fakify(meta), masters


def serve_forward(cfg, model: torch.nn.Module) -> Callable:
    """`images -> outputs` as `PredictEngine.forward` and `_run` compute
    them: the normalized input at the model's dtype, the first output of
    a classifier, segmentation's argmax masks, float leaves in f32."""
    from ..core.steps import normalize_input
    from ..serve.engine import argmax_masks, tree_map

    take_first = cfg.family == "classification"

    def forward(images):
        with torch.inference_mode():
            out = model(normalize_input(images, _input_norm(cfg),
                                        model.dtype))
            if take_first and isinstance(out, (tuple, list)):
                out = out[0]
            if cfg.family == "segmentation":
                out = argmax_masks(out)
            return tree_map(lambda t: t.float() if t.is_floating_point()
                            else t, out)

    return forward


def _serve_unit(name, cfg) -> TracedUnit:
    """SERVE facts of one servable config (the engine's default buckets
    against the input spec, and the output at bucket 1) and the serve
    forward traced at the audit batch: the row the int8 twins are held
    against."""
    cfg = pin_trace_impls(cfg)
    model, masters = served_model(cfg)
    forward = serve_forward(cfg, model)
    buckets, max_batch = engine_buckets()
    probe = {buckets[0]: _specs(forward(_images(cfg, buckets[0])))}
    trace, out = record(forward, _images(cfg))
    return TracedUnit(
        f"{name}/serve", name, "predict", trace, _specs(out),
        meta={"compute_dtype": model.dtype, "kind": "predict"},
        head_dims=head_dims(cfg),
        serve={"buckets": buckets, "max_batch": max_batch,
               "example_shape": tuple(_images(cfg).shape[1:]),
               "probe_outs": probe},
        param_bytes=param_bytes(masters))


# -- epoch, int8 and attention units ------------------------------------------

def epoch_unit_names() -> List[str]:
    return [f"epoch/{name}" for name in EPOCH_UNIT_CONFIGS]


def quant_unit_names() -> List[str]:
    return [f"quant/{name}" for name in QUANT_UNIT_CONFIGS]


def attn_unit_names() -> List[str]:
    return [f"attn/{ATTN_UNIT_CONFIG}/{impl}" for impl in ATTN_IMPLS]


def _epoch_unit(cname: str) -> TracedUnit:
    """One pass of `make_epoch_train_step` over EPOCH_LENGTH cached
    batches, shuffled by the epoch's permutation, the EMA after each step
    where the config keeps one."""
    from ..configs import get_config
    from ..core import segment as seg_lib
    from ..core import steps as steps_lib

    cfg = pin_trace_impls(get_config(cname))
    state = _state(_model(cfg), cfg, ema=bool(cfg.ema_decay))
    norm, n, sz = _input_norm(cfg), EPOCH_LENGTH, cfg.data.image_size
    images = _images(cfg, lead=(n,))
    if cfg.family == "segmentation":
        inner = seg_lib.make_segmentation_train_step(
            compute_dtype=_dtype(cfg), input_norm=norm,
            dice_weight=seg_lib.dice_weight_for(cfg),
            log_grad_norm=cfg.log_grad_norm)
        arrays = (images, torch.empty((n, AUDIT_BATCH, sz, sz),
                                      dtype=torch.int64))
    else:
        inner = steps_lib.make_classification_train_step(
            label_smoothing=cfg.label_smoothing,
            aux_weight=cfg.aux_loss_weight, compute_dtype=_dtype(cfg),
            input_norm=norm, log_grad_norm=cfg.log_grad_norm)
        arrays = (images, torch.empty((n, AUDIT_BATCH), dtype=torch.int64))
    step = steps_lib.make_epoch_train_step(inner)
    perm = steps_lib.draw_epoch_permutation(cfg.seed, 1, n * AUDIT_BATCH,
                                            torch.device("cpu"))
    return _traced(f"epoch/{cname}", "", "train", step,
                   (state, arrays, perm), head_dims(cfg))


def _quant_unit(cname: str) -> TracedUnit:
    """One config's int8 twin as the engine serves it: the plan of the
    served forward (`ops/quant.plan_quantization`), unit activation
    scales in place of calibration (a scale's value changes no op), the
    weights quantized from the f32 masters, and the forward under
    `Int8Mode`. The attention impl is the served one ("auto" is K1's
    operator), so the transformer twin's attention is K1's node, which
    the plan counts as `fused_attention`."""
    from ..configs import get_config
    from ..ops import quant as quant_lib

    cfg = get_config(cname)
    model, masters = served_model(cfg)
    forward = serve_forward(cfg, model)
    images = _images(cfg)
    head = head_dims(cfg)
    plan = quant_lib.plan_quantization(model, lambda: forward(images), head)
    plan.act_scales = [1.0] * len(plan.ops)
    qweights = quant_lib.quantize_weights(plan, masters)

    def int8_forward(x):
        mode = quant_lib.Int8Mode(plan, qweights)
        with mode:
            out = forward(x)
        mode.check()
        return out

    trace, out = record(int8_forward, images)
    return TracedUnit(
        f"quant/{cname}", "", "predict", trace, _specs(out),
        meta={"kind": "predict"}, head_dims=head,
        quant={"planned": len(plan.ops), "skipped_head": plan.skipped_head,
               "skipped_attention": plan.skipped_attention,
               "fused_attention": plan.fused_attention,
               "baseline_unit": f"{cname}/serve"},
        param_bytes=quant_lib.int8_state_nbytes(plan, masters))


def _attn_unit(impl: str) -> TracedUnit:
    """The ViT serve forward pinned to one attention lowering: "naive"
    (the einsums) or "fused" (K1's operator, one node a layer)."""
    from ..configs import get_config

    cfg = get_config(ATTN_UNIT_CONFIG)
    cfg = cfg.replace(
        model_kwargs={**cfg.model_kwargs, "attention_impl": impl},
        data=dataclasses.replace(cfg.data, image_size=ATTN_AUDIT_IMAGE))
    model, masters = served_model(cfg)
    trace, out = record(serve_forward(cfg, model), _images(cfg))
    return TracedUnit(
        f"attn/{ATTN_UNIT_CONFIG}/{impl}", "", "predict", trace,
        _specs(out), meta={"compute_dtype": model.dtype,
                           "kind": "predict"},
        head_dims=head_dims(cfg), param_bytes=param_bytes(masters))


# -- registry sweep -----------------------------------------------------------

_FAMILY_BUILDERS: Dict[str, Callable] = {
    "classification": _classification_units,
    "detection": _detection_units,
    "pose": _pose_units,
    "centernet": _centernet_units,
    "segmentation": _segmentation_units,
    "gan": _gan_units,
}


def config_names() -> List[str]:
    from .. import configs  # noqa: F401  (registers every config)
    from ..utils.registry import CONFIGS
    return [name for name, _ in CONFIGS.items()]


def config_unit_names(name: str) -> List[str]:
    """The units a registered config contributes, before tracing."""
    from ..configs import get_config
    cfg = get_config(name)
    if cfg.family == "gan":
        return ([f"{name}/train"] if cfg.model == "dcgan"
                else [f"{name}/train_gen", f"{name}/train_disc"])
    base = [f"{name}/train", f"{name}/eval", f"{name}/serve"]
    if cfg.family in ("detection", "centernet", "segmentation"):
        base.insert(2, f"{name}/predict")
    return base


def _guarded(name: str, kind: str, build: Callable[[], object]):
    """`build()` in a fresh fake mode; a failure becomes a TRACE error
    unit under `name`."""
    try:
        with fake_tensors():
            return build()
    except Exception as e:                     # noqa: BLE001 — a finding
        return TracedUnit(name, "", kind, error=f"{type(e).__name__}: {e}")


def build_units(names: Optional[List[str]] = None,
                progress: Optional[Callable[[str], None]] = None,
                epoch: bool = True, quant: bool = True,
                attn: bool = True) -> Iterator[TracedUnit]:
    """TracedUnits for the named configs (default: the whole registry),
    then the epoch, int8 and attention units. The caller drops each
    unit's trace before the next."""
    from ..configs import get_config

    for cname in config_names() if names is None else names:
        cfg = get_config(cname)
        if progress:
            progress(cname)
        builder = _FAMILY_BUILDERS.get(cfg.family)
        if builder is None:
            yield TracedUnit(f"{cname}/train", cname, "train",
                             error=f"config family {cfg.family!r} has no "
                                   f"audit builder")
            continue
        units = _guarded(f"{cname}/train", "train",
                         lambda: builder(cname, cfg))
        for u in units if isinstance(units, list) else [units]:
            u.config_name = cname
            yield u
        if cfg.family != "gan":
            u = _guarded(f"{cname}/serve", "predict",
                         lambda: _serve_unit(cname, cfg))
            u.config_name = cname
            yield u
        del units
        gc.collect()
    if epoch:
        for cname in EPOCH_UNIT_CONFIGS:
            yield _guarded(f"epoch/{cname}", "train",
                           lambda: _epoch_unit(cname))
    if quant:
        for cname in QUANT_UNIT_CONFIGS:
            yield _guarded(f"quant/{cname}", "predict",
                           lambda: _quant_unit(cname))
    if attn:
        for impl in ATTN_IMPLS:
            yield _guarded(f"attn/{ATTN_UNIT_CONFIG}/{impl}", "predict",
                           lambda: _attn_unit(impl))
    gc.collect()
