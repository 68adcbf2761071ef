"""Call-order Keras → port weight conversion (own copy of
deepvision_tpu/utils/order_convert.py).

For architectures ported layer for layer, the reference model's weighted
Keras layers and the port model's weighted modules correspond one to one
*per kind, in creation order*: Keras auto-names carry a per-type creation
counter (`conv2d_7`, `batch_normalization_12`), and forward hooks on the
port's `Conv`, `ConvTranspose`, `Dense` and `BatchNorm`
(models/common.py) recover the model's call order, as the JAX package's
`nn.intercept_methods` recorder recovers Flax's. Pairing the per-kind
sequences converts such a checkpoint without a per-layer name table.
Pairing per kind, not over the one interleaved sequence, matters because
Keras `model.layers` is topological order, which permutes parallel
branches, while the per-type counters are pure creation order.

This holds only where the port calls each kind's modules in the order
Flax does (`models/hourglass.py::PreActBottleneck` calls `proj` before
its BN-conv chain, as the JAX model does): a port module that reorders
its calls pairs wrongly, which the parity tests against the JAX importer
catch.

Used for the Stacked Hourglass h5 import (`tools/import_keras_checkpoint
-m hourglass104`). Keras Conv2D and Dense kernels are HWIO / IO, as
Flax's; Conv2DTranspose's (kh, kw, out, in) becomes Flax's (kh, kw, in,
out) flipped in space. The Flax-layout weights then go through
utils/flax_convert.py's leaf rules into the module's state_dict, so the
transposed conv's flip is done once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .flax_convert import _convert_leaf

_NAME_PREFIXES = (  # longest first: conv2d_transpose starts with conv2d
    ("conv2d_transpose", "ConvTranspose"),
    ("batch_normalization", "BatchNorm"),
    ("conv2d", "Conv"),
    ("dense", "Dense"),
)
_BN_PARAMS = {"gamma": "scale", "beta": "bias"}
_BN_STATS = {"moving_mean": "mean", "moving_variance": "var"}


def _weighted_kinds():
    from ..models.common import BatchNorm, Conv, ConvTranspose, Dense
    return ((ConvTranspose, "ConvTranspose"), (Conv, "Conv"),
            (Dense, "Dense"), (BatchNorm, "BatchNorm"))


def _kind_of(module: torch.nn.Module):
    for cls, kind in _weighted_kinds():
        if isinstance(module, cls):
            return kind
    return None


def modules_in_call_order(module: torch.nn.Module, *inputs
                          ) -> List[Tuple[str, str]]:
    """[(module name, kind)] of every weighted module in first-call order
    over one eval-mode forward of `module` at `inputs`. The hooks go on
    for that forward only."""
    records: List[Tuple[str, str]] = []
    seen = set()
    handles = []

    def hook(name: str, kind: str):
        def record(mod, args, out):
            if name not in seen:          # a shared module: its first call
                seen.add(name)
                records.append((name, kind))
        return record

    was_training = module.training
    try:
        for name, mod in module.named_modules():
            kind = _kind_of(mod)
            if kind is not None:
                handles.append(mod.register_forward_hook(hook(name, kind)))
        module.eval()
        with torch.no_grad():
            module(*inputs)
    finally:
        for h in handles:
            h.remove()
        module.train(was_training)
    uncalled = [name for name, mod in module.named_modules()
                if _kind_of(mod) is not None and name not in seen]
    if uncalled:
        raise ValueError(f"weighted modules never called at the sample "
                         f"input, so nothing can pair them: {uncalled[:5]}")
    return records


def _kind_and_counter(lname: str) -> Tuple[str, int]:
    """('conv2d_7' → ('Conv', 7)); counter 0 for the unsuffixed first
    layer."""
    for prefix, kind in _NAME_PREFIXES:
        if lname == prefix:
            return kind, 0
        if lname.startswith(prefix + "_"):
            tail = lname[len(prefix) + 1:]
            if tail.isdigit():
                return kind, int(tail)
    raise NotImplementedError(f"unrecognized auto-generated layer name "
                              f"{lname!r}")


def layers_from_legacy_h5(path: str
                          ) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """[(kind, {attr: array})] from a TF2.1-era `save_weights` h5
    (per-layer groups named with the auto-name counters), in per-type
    creation order. File walking is `keras_convert.load_h5_weights`;
    on-disk order is irrelevant because the counters carry the order."""
    from .keras_convert import load_h5_weights

    rows = []
    for lname, weights in load_h5_weights(path).items():
        kind, counter = _kind_and_counter(lname)
        rows.append((kind, counter, weights))
    rows.sort(key=lambda r: (r[0], r[1]))
    return [(kind, weights) for kind, _, weights in rows]


def _flax_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """A port weight's shape in Flax's layout (OIHW → HWIO, (out, in) →
    (in, out)), for the error messages JAX's importer gives."""
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return tuple(reversed(shape)) if len(shape) == 2 else tuple(shape)


def convert_by_call_order(module: torch.nn.Module, keras_layers, *inputs
                          ) -> Dict[str, torch.Tensor]:
    """Map ordered Keras weight layers onto `module`'s state_dict (f32
    tensors on the CPU; `num_batches_tracked` left as it is, so load it
    with `strict=False`).

    Fails loudly on any count, kind, shape or bias mismatch, with the JAX
    importer's words: a structural disagreement between the two models
    means the order pairing is wrong and nothing should be imported."""
    ordered = modules_in_call_order(module, *inputs)
    if len(ordered) != len(keras_layers):
        raise ValueError(
            f"layer count mismatch: flax model has {len(ordered)} weighted "
            f"modules, checkpoint has {len(keras_layers)}")
    # both sides sorted by (kind, per-kind order): call order within a
    # kind is the creation order the Keras auto-name counters carry
    by_kind: Dict[str, List[str]] = {}
    for name, kind in ordered:
        by_kind.setdefault(kind, []).append(name)
    seq = [(kind, name) for kind in sorted(by_kind)
           for name in by_kind[kind]]
    expected = module.state_dict()
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, leaf: str, value, stats: bool, where: str) -> None:
        key, value = _convert_leaf((leaf,), np.asarray(value), stats)
        full = f"{name}.{key}" if name else key
        path = name.replace(".", "/")
        if full not in expected:
            raise KeyError(f"{where}: no weight {leaf!r} at {path}")
        want = tuple(expected[full].shape)
        if tuple(value.shape) != want:
            got = value.shape
            if key == "weight" and value.ndim in (2, 4):
                got, want = _flax_shape(got), _flax_shape(want)
            raise ValueError(
                f"{where} {path}/{leaf}: checkpoint shape {got} != "
                f"model {want}")
        out[full] = torch.tensor(np.ascontiguousarray(value),
                                 dtype=torch.float32)

    for i, ((model_kind, name), (kind, weights)) in enumerate(
            zip(seq, keras_layers)):
        where = f"layer {i} ({name.replace('.', '/')})"
        if kind != model_kind:
            raise ValueError(f"{where}: checkpoint layer is {kind}, "
                             f"model expects {model_kind} — per-kind layer "
                             f"counts differ between checkpoint and model")
        if kind == "BatchNorm":
            for src, dst in _BN_PARAMS.items():
                put(name, dst, weights[src], False, where)
            for src, dst in _BN_STATS.items():
                put(name, dst, weights[src], True, where)
            continue
        kernel = weights["kernel"]
        # ConvTranspose: (kh, kw, out, in) → flipped (kh, kw, in, out)
        if kind == "ConvTranspose":
            kernel = np.transpose(kernel, (0, 1, 3, 2))[::-1, ::-1]
        put(name, "kernel", kernel, False, where)
        has_bias = f"{name}.bias" in expected
        if has_bias != ("bias" in weights):
            # a silent keep of the module's random bias (or a dropped
            # checkpoint bias) would import a subtly wrong model
            raise ValueError(f"{where}: bias mismatch — model "
                             f"{'has' if has_bias else 'lacks'} one, "
                             f"checkpoint "
                             f"{'has' if 'bias' in weights else 'lacks'} one")
        if has_bias:
            put(name, "bias", weights["bias"], False, where)
    return out
