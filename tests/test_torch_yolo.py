"""Port YOLO V3 (deepvision_tpu_torch/{ops/yolo,ops/boxes,models/yolo}.py)
against the JAX package on the CPU.

The same numpy inputs and weights (seeded) go through both. Weights are
Flax variables (`params` + `batch_stats`) of the shapes `YoloV3.init`
gives, filled from numpy, carried over by the weight bridge
(deepvision_tpu_torch/utils/flax_convert.py). The tiny model is Darknet-53
at width_mult 0.125 with stages (1, 1, 1, 1, 1), 4 classes, 64 px.

Bounds:
- box coding, anchors, labels: exact or 1e-6 (the same f32 operations);
- loss components: 1e-5 relative (sums over the grid in another order);
- f32 forward: 1e-4 relative to the largest head value — only the
  convolutions' summation order differs, compounded over 30 conv layers;
- bf16 forward: 5e-2 relative, in eval mode — both round every conv
  output to bf16, but their convolutions sum in different orders, so a
  bf16 ulp (0.4%) flips here and there and compounds over the layers. (In
  train mode the 2x2 grid's BatchNorm normalizes 8 values per channel and
  amplifies such flips without bound: the JAX model's own bf16 heads differ
  from its f32 ones by 0.69 there, so train mode is compared in f32 only.)
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepvision_tpu.configs import get_config as jax_get_config
from deepvision_tpu.models.yolo import YoloV3 as JaxYoloV3
from deepvision_tpu.ops import boxes as jax_boxes
from deepvision_tpu.ops import yolo as jax_yolo
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.models.yolo import Conv, YoloV3, upsample2x
from deepvision_tpu_torch.ops import boxes as port_boxes
from deepvision_tpu_torch.ops import yolo as port_yolo
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict

TINY = dict(num_classes=4, width_mult=0.125, stage_blocks=(1, 1, 1, 1, 1))
SIZE = 64
GRIDS = (8, 4, 2)
BOUND = {"float32": 1e-4, "bfloat16": 5e-2}
# the JAX oracles, compiled once instead of run op by op
jax_encode_labels = jax.jit(jax_yolo.encode_labels, static_argnums=3)
jax_yolo_loss = jax.jit(jax_yolo.yolo_loss, static_argnums=4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def flax_yolo_variables(model, x: np.ndarray, seed: int = 0):
    """(params, batch_stats) numpy trees of `model`'s shapes, filled from a
    seeded numpy stream: lecun-scaled kernels, and biases, BatchNorm scales
    and statistics away from their init values so that a bridge that
    dropped or misplaced a leaf could not pass."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=True))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            v = 1.0 + 0.2 * rs.rand(*shape)
        else:                           # bias, mean
            v = 0.1 * rs.randn(*shape)
        return v.astype(np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return filled["params"], filled["batch_stats"]


def _images(n=2, seed=1):
    return (np.random.RandomState(seed).rand(n, SIZE, SIZE, 3)
            .astype(np.float32) * 2 - 1)


def _boxes(rs, b, n):
    xy1 = rs.uniform(0.0, 0.7, (b, n, 2))
    wh = rs.uniform(0.02, 0.5, (b, n, 2))
    return np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)


# -- configs --------------------------------------------------------------

@pytest.mark.parametrize("name", ["yolov3", "yolov3_voc", "yolov3_digits"])
def test_configs_equal_the_jax_ones(name):
    port, ref = get_config(name), jax_get_config(name)

    def same(a, b):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(va):
                same(va, vb)
            else:
                assert va == vb, f"{name}.{f.name}: {va!r} != {vb!r}"

    same(port, ref)


# -- box coding, anchors, labels ------------------------------------------

def test_box_converters_match_jax():
    box = _boxes(np.random.RandomState(0), 3, 11)
    for fn in ("xywh_to_x1y1x2y2", "x1y1x2y2_to_xywh", "xywh_to_y1x1y2x2"):
        want = np.asarray(getattr(jax_boxes, fn)(jnp.asarray(box)))
        got = getattr(port_boxes, fn)(torch.from_numpy(box)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_decode_and_encode_match_jax():
    rs = np.random.RandomState(1)
    y_pred = rs.randn(2, 4, 4, 3, 9).astype(np.float32)
    anchors = np.asarray(jax_yolo.ANCHORS_WH[3:6])
    want = jax_yolo.decode_boxes(jnp.asarray(y_pred), anchors, 4)
    got = port_yolo.decode_boxes(torch.from_numpy(y_pred),
                                 port_yolo.ANCHORS_WH[3:6], 4)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    y_true = np.abs(rs.rand(2, 4, 4, 3, 4)).astype(np.float32)
    y_true[0, 1, 2] = 0.0                # empty cells: tw = th = 0
    want = jax_yolo.encode_boxes(jnp.asarray(y_true), anchors)
    got = port_yolo.encode_boxes(torch.from_numpy(y_true),
                                 port_yolo.ANCHORS_WH[3:6])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_anchor_constants_and_best_anchor_match_jax():
    np.testing.assert_array_equal(port_yolo.ANCHORS_WH.numpy(),
                                  jax_yolo.ANCHORS_WH)
    boxes = _boxes(np.random.RandomState(2), 4, 50)
    want = np.asarray(jax_yolo.find_best_anchor(jnp.asarray(boxes)))
    got = port_yolo.find_best_anchor(torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, want)


def _encode_both(boxes, classes, valid, num_classes=4):
    onehot = np.eye(num_classes, dtype=np.float32)[classes]
    want = jax_encode_labels(jnp.asarray(onehot), jnp.asarray(boxes),
                             jnp.asarray(valid), GRIDS)
    got = port_yolo.encode_labels(torch.from_numpy(onehot),
                                  torch.from_numpy(boxes),
                                  torch.from_numpy(valid), GRIDS)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_encode_labels_match_jax_on_random_boxes():
    rs = np.random.RandomState(3)
    boxes = _boxes(rs, 3, 100)
    classes = rs.randint(0, 4, (3, 100))
    valid = (rs.rand(3, 100) < 0.3).astype(np.float32)
    want, got = _encode_both(boxes, classes, valid)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
    assert sum(float(w[..., 4].sum()) for w in want) > 10


def test_encode_labels_last_valid_box_wins_and_out_of_scale_drops():
    """Boxes 0, 1, 3 fall in one cell with one anchor: box 3 (valid, last)
    wins, box 2 (invalid) and the later invalid ones never write. Box 4's
    center is exactly 1.0 (cell g: dropped, not clamped); box 5's center
    is negative (cell -1 wraps to g - 1, as the JAX scatter indexes)."""
    same = [0.30, 0.30, 0.40, 0.42]
    boxes = np.zeros((1, 8, 4), np.float32)
    boxes[0, :4] = same
    boxes[0, 4] = [0.95, 0.95, 1.05, 1.05]
    boxes[0, 5] = [-0.20, 0.30, 0.08, 0.42]
    classes = np.array([[0, 1, 2, 3, 1, 2, 0, 0]])
    valid = np.array([[1, 1, 0, 1, 1, 1, 0, 0]], np.float32)
    want, got = _encode_both(boxes, classes, valid)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
    targets = np.concatenate([g[0].reshape(-1, 9) for g in got])
    written = targets[targets[:, 4] > 0]
    # one target for boxes 0/1/3, one for box 5; box 4 was dropped
    assert len(written) == 2
    collided = written[np.isclose(written[:, 0], 0.35)]
    assert np.argmax(collided[0, 5:]) == 3      # box 3's class won


def test_yolo_loss_components_match_jax():
    rs = np.random.RandomState(4)
    boxes = _boxes(rs, 2, 100)
    classes = rs.randint(0, 4, (2, 100))
    valid = np.zeros((2, 100), np.float32)
    valid[:, :5] = 1.0
    want_t, got_t = _encode_both(boxes, classes, valid)
    preds = [(rs.randn(2, g, g, 3, 9) * 0.5).astype(np.float32)
             for g in GRIDS]
    want = jax_yolo_loss([jnp.asarray(t) for t in want_t],
                         [jnp.asarray(p) for p in preds],
                         jnp.asarray(boxes), jnp.asarray(valid), 4)
    got = port_yolo.yolo_loss([torch.from_numpy(t) for t in got_t],
                              [torch.from_numpy(p) for p in preds],
                              torch.from_numpy(boxes),
                              torch.from_numpy(valid), 4)
    assert set(got) == set(want) == {"xy", "wh", "class", "obj", "total"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)


# -- the model ------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_f32():
    x = _images()
    jax_model = JaxYoloV3(**TINY, dtype=jnp.float32)
    params, stats = flax_yolo_variables(jax_model, x)
    return x, jax_model, params, stats


@functools.cache
def _jitted_apply(model, static: tuple):
    return jax.jit(model.apply, static_argnames=static)


def _apply(model, variables, x, **kw):
    """`model.apply` compiled once instead of run op by op."""
    return _jitted_apply(model, tuple(sorted(kw)))(variables, jnp.asarray(x),
                                                   **kw)


def _port_model(params, stats, dtype=torch.float32):
    model = YoloV3(**TINY, dtype=dtype)
    model.load_state_dict(params_to_state_dict(params, model, stats))
    return model


def _close(got, want, bound):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def test_raw_heads_and_batch_stats_in_train_mode_match_flax(tiny_f32):
    x, jax_model, params, stats = tiny_f32
    want, mutated = _apply(jax_model, {"params": params,
                                       "batch_stats": stats}, x,
                           train=True, mutable=("batch_stats",))
    model = _port_model(params, stats).train()
    got = model(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, g, g, 3, 9) for g in GRIDS]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, BOUND["float32"])
    # one step of running statistics: Flax folds the BIASED batch variance
    ref = params_to_state_dict(params, model,
                               jax.device_get(mutated["batch_stats"]))
    sd = model.state_dict()
    for k in ref:
        if "running" in k:
            torch.testing.assert_close(sd[k], ref[k], rtol=1e-5, atol=1e-5)


def test_raw_and_decoded_heads_in_eval_mode_match_flax(tiny_f32):
    x, jax_model, params, stats = tiny_f32
    variables = {"params": params, "batch_stats": stats}
    model = _port_model(params, stats).eval()
    with torch.no_grad():
        raw = model(torch.from_numpy(x), decode=False)
        decoded = model(torch.from_numpy(x))
    want_raw = _apply(jax_model, variables, x, train=False, decode=False)
    for g, w in zip(raw, want_raw):
        _close(g, w, BOUND["float32"])
    want_dec = _apply(jax_model, variables, x, train=False)
    for g3, w3 in zip(decoded, want_dec):
        for g, w in zip(g3, w3):        # boxes, objectness, class probs
            _close(g, w, BOUND["float32"])


def test_bf16_forward_matches_flax():
    x = _images(seed=5)
    jax_model = JaxYoloV3(**TINY, dtype=jnp.bfloat16)
    params, stats = flax_yolo_variables(jax_model, x, seed=6)
    want = _apply(jax_model, {"params": params, "batch_stats": stats}, x,
                  train=False, decode=False)
    model = _port_model(params, stats, torch.bfloat16).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), decode=False)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32       # the final conv runs in f32
        _close(g, w, BOUND["bfloat16"])


@pytest.mark.parametrize("size", [8, 9])
def test_stride2_same_padding_is_asymmetric_like_flax(size):
    """SAME on a stride-2 3x3 conv pads 0 before and 1 after an even input
    (symmetric 1/1 on an odd one); torch's padding=1 shifts the windows."""
    rs = np.random.RandomState(size)
    x = rs.randn(1, size, size, 3).astype(np.float32)
    conv = fnn.Conv(5, (3, 3), strides=(2, 2), padding="SAME",
                    use_bias=False)
    params = {"kernel": rs.randn(3, 3, 3, 5).astype(np.float32)}
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    port = Conv(3, 5, 3, strides=2)
    port.weight.data = torch.from_numpy(
        params["kernel"].transpose(3, 2, 0, 1).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = port(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    shifted = F.conv2d(xt, port.weight, stride=2, padding=1)
    assert shifted.shape == port(xt).shape
    if size % 2 == 0:
        assert np.abs(shifted.permute(0, 2, 3, 1).detach().numpy()
                      - want).max() > 1e-2


def test_upsample_repeats_each_pixel_like_jax_resize():
    x = np.random.RandomState(7).randn(2, 3, 5, 4).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 6, 10, 4),
                                       method="nearest"))
    got = upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_bridge_raises_on_a_missing_or_an_extra_leaf(tiny_f32):
    _, _, params, stats = tiny_f32
    model = YoloV3(**TINY, dtype=torch.float32)
    sd = params_to_state_dict(params, model, stats)
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) == len(model.state_dict()) - sum(
        1 for k in model.state_dict() if k.endswith("num_batches_tracked"))
    missing = jax.tree_util.tree_map(lambda a: a, stats)
    del missing["tower_small"]["ConvBNLeaky_5"]["BatchNorm_0"]["var"]
    with pytest.raises(KeyError, match="running_var"):
        params_to_state_dict(params, model, missing)
    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["darknet53"]["ConvBNLeaky_9"] = extra["darknet53"]["ConvBNLeaky_0"]
    with pytest.raises(KeyError, match="ConvBNLeaky_9"):
        params_to_state_dict(extra, model, stats)
