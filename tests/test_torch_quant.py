"""The port's int8 quantization (deepvision_tpu_torch/ops/quant.py and the
plan, calibration and int8 forward behind serve/quantize.py) held to the
JAX package's `ops/quant.py` and `serve/quantize.py` on the same weights
and the same pinned shard.

The JAX modules import on this jax through a shim: `jax.core`'s `Jaxpr`,
`ClosedJaxpr`, `JaxprEqn` and `Literal` are set from `jax.extend.core`
with a monkeypatch, `serve/quantize.py` loads under the stand-in of
tests/test_torch_serve_ops.py::jax_serve_modules, and on exit every
`deepvision_tpu.serve*` module and `deepvision_tpu.ops.quant` is put back
as it was (`jax_quant_modules`; tests/test_torch_quant_serve.py imports
it from here).

Per family (lenet5, vit_tiny with JAX's attention in interpret mode,
unet_synthetic, yolov3_digits, mobilenet_v1 at 32 px, centernet_digits):
the Flax variables from `jax.eval_shape` filled from numpy and carried
across by the weight bridge; one calibration on the first
`CALIB_EXAMPLES` of the port's pinned shard on both sides. Held equal:
- the plan summary, and the planned weights by name in planned order
  (the JAX leaf paths mapped by utils/flax_convert.py);
- the int8 weights bit for bit and their scales exactly (data-free, from
  the same f32 weights);
- the activation scales: 1e-6 relative under the f32 policy (lenet5);
  under bf16 an activation's absmax may land one bf16 step apart on the
  two backends, and the scales within `BF16_SCALE_RTOL` (measured: at
  most 7.5e-3, yolov3_digits; 7.1e-3, vit_tiny);
- the first planned op's int8 activations (the port's padded input
  cropped to XLA's) and int32 accumulators, bit for bit, in every family;
- the int8 outputs of 4 examples within `OUT_RTOL` of the largest output
  of JAX's `quantized_predict_fn` (measured: 3.5e-7 lenet5 and
  mobilenet_v1, 0.023 vit_tiny), with the same argmax; for
  unet_synthetic at least `MASK_AGREE` of the mask pixels (measured: all
  of them); for yolov3_digits, whose decoded boxes of random weights
  reach 4.7e4, the port's mean distance from JAX's int8 at most
  `NOISE_RATIO` times JAX's own int8-to-bf16 mean distance, per leaf
  (measured: at most 1.08: the scales one bf16 step apart round some
  activations the other way, as int8 rounds them away from bf16);
centernet_digits refuses with "nothing to quantize" on both sides.
Then the `MAX_ACC_TAPS` guard, the zero-activation scale and
`QuantRefusal`'s reason, and a `slow` test of the full-size plans
against JAX's (too slow for the tier-1 run: every full-size JAX trace
takes 1-70 s).
"""

import contextlib
import dataclasses
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.configs import get_config as jax_get_config
from deepvision_tpu.core.steps import _normalize_input
from deepvision_tpu.core.trainer import build_model_from_config
from deepvision_tpu_torch.core import scoring
from deepvision_tpu_torch.models import build_model
from deepvision_tpu_torch.ops import quant
from deepvision_tpu_torch.serve.engine import (PredictEngine, argmax_masks,
                                               config_at)
from deepvision_tpu_torch.serve.quantize import Quantizer
from deepvision_tpu_torch.utils.flax_convert import _convert_leaf
from test_torch_serve_ops import jax_serve_modules
from test_torch_zoo_oracle import bridge

CALIB_EXAMPLES = 16
BF16_SCALE_RTOL = 1e-2
OUT_RTOL = {"lenet5": 1e-5, "vit_tiny": 0.03, "mobilenet_v1": 1e-5}
MASK_AGREE = 0.98
NOISE_RATIO = 1.5
FAMILIES = {"lenet5": None, "vit_tiny": None, "unet_synthetic": None,
            "yolov3_digits": None, "mobilenet_v1": 32}
_SHIM = ("Jaxpr", "ClosedJaxpr", "JaxprEqn", "Literal")


@contextlib.contextmanager
def jax_quant_modules(*serve_names):
    """JAX's `ops/quant.py` (as `.quant`) and `serve/<name>.py` for
    "quantize" and each of `serve_names`, importable through the
    `jax.extend.core` shim; afterwards `sys.modules`, `jax.core` and the
    `deepvision_tpu.ops` package are as they were."""
    import jax.extend.core as jex
    import deepvision_tpu.ops as jax_ops
    key = "deepvision_tpu.ops.quant"
    had_attr = "quant" in vars(jax_ops)
    saved = sys.modules.get(key)
    with pytest.MonkeyPatch.context() as mp:
        for name in _SHIM:
            mp.setattr(jax.core, name, getattr(jex, name), raising=False)
        try:
            with jax_serve_modules("quantize", *serve_names) as mods:
                mods.quant = importlib.import_module(key)
                yield mods
        finally:
            sys.modules.pop(key, None)
            if saved is not None:
                sys.modules[key] = saved
            if not had_attr:
                vars(jax_ops).pop("quant", None)


@pytest.fixture(scope="module")
def jq():
    with jax_quant_modules() as mods:
        yield mods


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_predict(jax_model, cfg):
    """The JAX engine's predict function of `cfg` (serve/engine.py):
    normalized input, the first output of a classifier, the masks of a
    segmenter, float leaves as f32."""
    norm = ((cfg.data.mean, cfg.data.std) if cfg.data.normalize_on_device
            else None)
    dtype = jnp.dtype(cfg.dtype) if cfg.dtype else jnp.bfloat16

    def predict(variables, images):
        out = jax_model.apply(variables, _normalize_input(images, norm,
                                                          dtype),
                              train=False)
        if cfg.family == "classification" and isinstance(out, (tuple,
                                                               list)):
            out = out[0]
        if cfg.family == "segmentation":
            out = jnp.argmax(out, axis=-1).astype(jnp.int32)
        return jax.tree_util.tree_map(
            lambda y: y.astype(jnp.float32)
            if jnp.issubdtype(y.dtype, jnp.floating) else y, out)
    return predict


def twins(name, size=None, model_kwargs=None):
    """(JAX model, Flax variables, JAX config, port engine on the CPU,
    port config): one config's two models on the same filled weights."""
    jcfg = jax_get_config(name)
    cfg = config_at(name, size)
    if size:
        jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data,
                                                     image_size=size))
    if model_kwargs:
        jcfg = jcfg.replace(model_kwargs={**jcfg.model_kwargs,
                                          **model_kwargs})
    jax_model, jcfg = build_model_from_config(jcfg)
    s, c = cfg.data.image_size, cfg.data.channels
    model = build_model(cfg)
    variables = bridge(jax_model, model, np.zeros((2, s, s, c), np.float32))
    engine = PredictEngine(
        model, example_shape=(s, s, c), device="cpu", buckets=(1, 4),
        input_norm=((cfg.data.mean, cfg.data.std)
                    if cfg.data.normalize_on_device else None),
        take_first_output=cfg.family == "classification",
        output_transform=(argmax_masks if cfg.family == "segmentation"
                          else None),
        name=cfg.name, verbose=False)
    return jax_model, variables, jcfg, engine, cfg


def shard(engine, cfg, n=CALIB_EXAMPLES):
    images, _ = scoring.pinned_shard(cfg, image_size=engine.example_shape[0],
                                     input_dtype=engine.input_dtype,
                                     examples=n)
    return images


def port_quantizer(engine, images, head_dims):
    def forward():
        with torch.inference_mode():
            return engine.forward(engine.model, images)
    return Quantizer(engine.model, forward, head_dims)


def port_names(jq_quant, plan, variables):
    """The port parameter name of each planned JAX leaf, in planned
    order."""
    leaves = [(tuple(getattr(k, "key", k) for k in path), value)
              for path, value
              in jax.tree_util.tree_flatten_with_path(variables)[0]]
    names = []
    for q in plan.eqns:
        path, value = leaves[q.leaf_index]
        names.append(_convert_leaf(path[1:], np.asarray(value),
                                   path[0] == "batch_stats")[0])
    return names


def torch_layout(w: np.ndarray) -> np.ndarray:
    """A Flax kernel (HWIO conv, (in, out) dense) in the port's layout."""
    w = np.asarray(w)
    return w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T


class _Capture:
    """Records the first call's result of a function of ops/quant.py."""

    def __init__(self, fn):
        self.fn, self.first = fn, None

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        if self.first is None:
            self.first = out.clone()
        return out


_CACHE = {}


def family(jq, name):
    """Everything the parity tests compare for one config, computed once."""
    if name in _CACHE:
        return _CACHE[name]
    kwargs = {"attention_impl": "interpret"} if name == "vit_tiny" else None
    jax_model, variables, jcfg, engine, cfg = twins(name, FAMILIES[name],
                                                     kwargs)
    images = shard(engine, cfg)
    head_dims = scoring.serving_head_dims(cfg)
    predict = jax_predict(jax_model, jcfg)
    jquant = jq.quantize.Quantizer(predict, variables, jnp.asarray(images),
                                   head_dims=head_dims)
    pquant = port_quantizer(engine, images, head_dims)
    jplan = jquant._calib_plan
    qv = jquant.quantize(variables)
    x = images[:4]
    qpredict = jax.jit(jquant.quantized_fn(
        variables, jax.ShapeDtypeStruct(x.shape, x.dtype)))
    want = jax.device_get(qpredict(qv, x))
    jitted = jax.jit(predict)
    bf16 = jax.device_get(jitted(variables, x))
    # the first planned op on the JAX side: its int8 input and int32
    # accumulator from one replay of the calibration batch
    first = jplan.eqns[0]
    closed = jax.make_jaxpr(predict)(variables, images)
    s_x = jplan.act_scales[first.eqn_index]
    got_first = {}

    def handler(idx, eqn, invals):
        if idx == first.eqn_index:
            qx = jnp.clip(jnp.round(invals[0].astype(jnp.float32)
                                    * (1.0 / s_x)), -127, 127).astype(
                jnp.int8)
            acc = eqn.primitive.bind(
                qx, qv["q"][str(first.leaf_index)]["w"],
                **dict(eqn.params,
                       preferred_element_type=jnp.dtype(jnp.int32)))
            got_first.update(qx=np.asarray(qx), acc=np.asarray(acc))
        return NotImplemented

    args = jax.tree_util.tree_leaves(variables) + [jnp.asarray(images)]
    jq.quant._replay(closed.jaxpr, closed.consts, args, handler)
    # the port's: the first quantize and product calls of its int8 forward
    capture_x = _Capture(quant.quantize_activation)
    capture_acc = _Capture(quant.int8_conv2d if pquant.plan.ops[0].prim
                           == "conv2d" else quant.int8_matmul)
    qweights = pquant.quantize(engine._masters)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quant, "quantize_activation", capture_x)
        mp.setattr(quant, capture_acc.fn.__name__, capture_acc)
        with torch.inference_mode():
            pquant.run(lambda: engine.forward(engine.model, images),
                       qweights)
    with torch.inference_mode():
        got = pquant.run(lambda: engine.forward(engine.model, x), qweights)
    out = {"jplan": jplan, "jscales": list(jquant._scales), "qv": qv,
           "names": port_names(jq.quant, jplan, variables),
           "pplan": pquant.plan, "qweights": qweights,
           "want": want, "bf16": bf16, "got": jax.tree_util.tree_map(
               lambda t: t.float().numpy() if t.is_floating_point()
               else t.numpy(), got, is_leaf=torch.is_tensor),
           "first": got_first, "port_first": (capture_x.first,
                                              capture_acc.first),
           "family": cfg.family}
    _CACHE[name] = out
    return out


@pytest.mark.parametrize("name", list(FAMILIES))
def test_plan_equals_jax(jq, name):
    f = family(jq, name)
    assert f["pplan"].summary() == f["jplan"].summary()
    assert [op.param for op in f["pplan"].ops] == f["names"]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_int8_weights_and_scales_equal_jax(jq, name):
    f = family(jq, name)
    for q, leaf, qw in zip(f["jplan"].eqns, f["names"], f["qweights"]):
        want = f["qv"]["q"][str(q.leaf_index)]
        np.testing.assert_array_equal(qw.w.numpy(),
                                      torch_layout(want["w"]), err_msg=leaf)
        np.testing.assert_array_equal(qw.s.numpy(), np.asarray(want["s"]),
                                      err_msg=leaf)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_activation_scales_equal_jax(jq, name):
    f = family(jq, name)
    got, want = np.asarray(f["pplan"].act_scales), np.asarray(f["jscales"])
    rtol = 1e-6 if name == "lenet5" else BF16_SCALE_RTOL
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_first_planned_op_bit_for_bit(jq, name):
    f = family(jq, name)
    qx, acc = f["port_first"]
    want_qx, want_acc = f["first"]["qx"], f["first"]["acc"]
    if qx.dim() == 4:
        # the port's NCHW against JAX's NHWC; the port's conv input comes
        # padded (Conv pads, then convolves), XLA's pads inside the conv:
        # the SAME padding puts total // 2 before
        qx, acc = qx.permute(0, 2, 3, 1), acc.permute(0, 2, 3, 1)
        (top, left) = ((qx.shape[d] - want_qx.shape[d]) // 2
                       for d in (1, 2))
        qx = qx[:, top:top + want_qx.shape[1], left:left + want_qx.shape[2]]
    assert qx.dtype == torch.int8 and acc.dtype == torch.int32
    np.testing.assert_array_equal(qx.numpy(), want_qx)
    np.testing.assert_array_equal(acc.reshape(want_acc.shape).numpy(),
                                  want_acc)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_int8_outputs_match_jax_quantized_predict(jq, name):
    f = family(jq, name)
    got = jax.tree_util.tree_leaves(f["got"])
    want = jax.tree_util.tree_leaves(f["want"])
    bf16 = jax.tree_util.tree_leaves(f["bf16"])
    assert len(got) == len(want) == len(bf16)
    for g, w, b in zip(got, want, bf16):
        w = np.asarray(w)
        g = g.reshape(w.shape) if g.size == w.size else g
        assert g.shape == w.shape
        if f["family"] == "segmentation":
            assert (g == w).mean() >= MASK_AGREE
            continue
        if f["family"] == "detection":
            noise = np.abs(w - np.asarray(b)).mean()
            assert np.abs(g - w).mean() <= NOISE_RATIO * noise
            continue
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel <= OUT_RTOL[name], rel
        if f["family"] == "classification":
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def test_centernet_has_nothing_to_quantize(jq):
    """CenterNet's head dims {2, 64, num_classes} cover every conv of the
    64-example calibration batch: both sides refuse."""
    jax_model, variables, jcfg, engine, cfg = twins("centernet_digits")
    # the 64 examples arm_int8 calibrates on: a batch of 64 is one of the
    # head dims, so every conv counts as a head
    images = shard(engine, cfg, 64)
    head_dims = scoring.serving_head_dims(cfg)
    with pytest.raises(ValueError, match="nothing to quantize"):
        jq.quantize.Quantizer(jax_predict(jax_model, jcfg), variables,
                              jnp.asarray(images), head_dims=head_dims)
    with pytest.raises(ValueError, match="nothing to quantize"):
        port_quantizer(engine, images, head_dims)


@pytest.fixture(scope="module")
def lenet(jq):
    jax_model, variables, jcfg, engine, cfg = twins("lenet5")
    return jax_predict(jax_model, jcfg), variables, engine, cfg


def _plans(jq, lenet, images, head_dims=frozenset()):
    predict, variables, engine, _ = lenet
    closed = jax.make_jaxpr(predict)(variables, images)
    jplan = jq.quant.plan_quantization(closed, head_dims)
    pplan = quant.plan_quantization(
        engine.model, lambda: engine.forward(engine.model, images),
        head_dims)
    return jplan, pplan


def test_accumulator_guard_equals_jax(jq, lenet, monkeypatch):
    """Contractions deeper than MAX_ACC_TAPS stay in float, on both
    sides alike."""
    images = shard(lenet[2], lenet[3], 2)
    full = _plans(jq, lenet, images)
    monkeypatch.setattr(jq.quant, "MAX_ACC_TAPS", 100)
    monkeypatch.setattr(quant, "MAX_ACC_TAPS", 100)
    clipped = _plans(jq, lenet, images)
    assert clipped[1].summary() == clipped[0].summary()
    assert len(clipped[1].ops) < len(full[1].ops)
    assert clipped[1].skipped_other > full[1].skipped_other


def test_zero_activation_scale_equals_jax(jq, lenet):
    """An all-zero calibration activation gets the scale 1/127."""
    predict, variables, engine, cfg = lenet
    images = np.zeros((2, *engine.example_shape), engine.input_dtype)
    head_dims = scoring.serving_head_dims(cfg)
    jquant = jq.quantize.Quantizer(predict, variables, jnp.asarray(images),
                                   head_dims=head_dims)
    pquant = port_quantizer(engine, images, head_dims)
    assert pquant.plan.act_scales[0] == 1.0 / quant.QMAX
    np.testing.assert_allclose(pquant.plan.act_scales, jquant._scales,
                               rtol=1e-6)


def test_quant_refusal_reason_equals_jax(jq):
    """Attention with no plannable projection (every projection a head
    by its width) is refused by name on both sides."""
    jax_model, variables, jcfg, engine, cfg = twins(
        "vit_tiny", model_kwargs={"attention_impl": "interpret"})
    images = shard(engine, cfg, 2)
    head_dims = frozenset({cfg.model_kwargs["embed_dim"]})
    closed = jax.make_jaxpr(jax_predict(jax_model, jcfg))(variables, images)
    with pytest.raises(jq.quant.QuantRefusal) as want:
        jq.quant.plan_quantization(closed, head_dims)
    with pytest.raises(quant.QuantRefusal) as got:
        quant.plan_quantization(
            engine.model, lambda: engine.forward(engine.model, images),
            head_dims)
    assert got.value.reason == want.value.reason \
        == "attention_projections_unquantizable"
    assert str(got.value) == str(want.value)


def test_int8_products_are_exact():
    """The int8 conv (plain, padded, strided, grouped, depthwise) and
    the padded product equal the int64 reference, at the shapes the card
    pads: k = 25 and 27, n = 6, m = 1."""
    rs = np.random.RandomState(0)

    def q(*shape):
        return torch.from_numpy(rs.randint(-127, 128, shape).astype(
            np.int8))

    a, w = q(1, 25), q(6, 25)
    np.testing.assert_array_equal(quant.int8_matmul(a, w).numpy(),
                                  a.long().numpy() @ w.long().numpy().T)
    for c, o, k, stride, pad, groups in ((3, 6, 3, 2, 1, 1),
                                         (1, 6, 5, 1, 0, 1),
                                         (8, 8, 3, 1, 1, 8),
                                         (6, 9, 1, 1, 0, 3),
                                         (4, 8, 3, 2, 1, 2)):
        x, wt = q(2, c, 9, 9), q(o, c // groups, k, k)
        got = quant.int8_conv2d(x, wt, stride, pad, 1, groups)
        want = torch.nn.functional.conv2d(x.double(), wt.double(), None,
                                          stride, pad, 1, groups)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.long().numpy())


@pytest.mark.slow
@pytest.mark.parametrize("names,want", [
    (("lenet5", "lenet5_digits"), (3, 2, 0)),
    (("alexnet1", "alexnet2"), (7, 1, 0)),
    (("vgg16",), (15, 1, 0)), (("vgg19",), (18, 1, 0)),
    (("inception_v1",), (57, 1, 0)), (("inception_v3",), (94, 1, 0)),
    (("resnet34",), (36, 1, 0)),
    (("resnet50", "resnet50v2", "resnet50_tpu"), (53, 1, 0)),
    (("resnet101",), (104, 1, 0)), (("resnet152",), (155, 1, 0)),
    (("mobilenet_v1",), (27, 1, 0)), (("shufflenet_v1",), (49, 1, 0)),
    (("vit_small",), (49, 1, 8)),
    (("yolov3", "yolov3_voc", "yolov3_digits"), (72, 3, 0)),
    (("hourglass104",), (187, 55, 0)),
    (("unet_resnet50",), (58, 1, 0)),
    (("unet_synthetic", "unet_digits"), (9, 1, 0)),
    (("centernet", "objects_as_points"), (0, 172, 0)),
    (("centernet_digits",), (0, 47, 0)),
])
def test_full_size_plans_equal_jax(jq, names, want):
    """Every served config at full size: the port's plan (on the meta
    device: shapes only) equals JAX's plan of its traced predict, as
    quantized / skipped_head / fused_attention."""
    for name in names:
        jcfg = jax_get_config(name)
        if name == "vit_small":
            jcfg = jcfg.replace(model_kwargs={**jcfg.model_kwargs,
                                              "attention_impl": "interpret"})
        jax_model, jcfg = build_model_from_config(jcfg)
        cfg = config_at(name)
        s, c = cfg.data.image_size, cfg.data.channels
        x = jax.ShapeDtypeStruct((64, s, s, c), np.float32)
        shapes = jax.eval_shape(lambda: jax_model.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((1, s, s, c)), train=True))
        closed = jax.make_jaxpr(jax_predict(jax_model, jcfg))(shapes, x)
        head_dims = scoring.serving_head_dims(cfg)
        jplan = jq.quant.plan_quantization(closed, head_dims)
        # shapes only, on the meta device; K1's plain version takes a CPU
        # tensor, so the ViT runs on the CPU
        device = "cpu" if cfg.family == "classification" \
            and cfg.model == "vit" else "meta"
        with torch.device(device):
            model = build_model(cfg).eval()
        images = torch.zeros((64, s, s, c), device=device)
        pplan = quant.plan_quantization(
            model, lambda: model(images.to(model.dtype)), head_dims)
        assert pplan.summary() == jplan.summary(), name
        assert (len(pplan.ops), pplan.skipped_head,
                pplan.fused_attention) == want, name
