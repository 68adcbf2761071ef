"""Port serving stack (deepvision_tpu_torch/serve/) on the CPU.

The engine pads and strips buckets without touching real rows, answers what
the JAX package's `_normalize_input` + `ViT.apply` answer on the same
(bridged) weights, and the HTTP front door answers the engine's own
reference logits. The bf16 bound against JAX, 1e-1 on logits of scale ~2,
covers bf16 activation roundings compounding over vit_tiny's 4 blocks.
The engine serves every classification family, not only ViT: LeNet-5 and a
reduced ResNet-50 here (tests/test_torch_zoo_oracle.py::check_engine: its
reference equals the model's own eval forward bit for bit, and a padded
bucket answers within 1e-3 of the largest logit), the zoo in their own
files, and every other classification config through `from_config` at
its full size (a padded bucket within 2e-2 of the largest logit: bf16).
It serves detection too: a tiny f32 yolov3 answers the decoded
(boxes, objectness, class_probs) of its three scales, equal row for row to
`reference()` at every padding (1e-5) and to the JAX model's decoded apply
on the same weights (1e-4 of each leaf's largest value); the batcher cuts
each request's rows out of every leaf of a coalesced tree, and `/predict`
answers the tree as nested lists. The pose and CenterNet families serve
their whole output trees — a heatmap per stack, a dict of heads per stack,
whose keys the tree helpers and the JSON answer keep — through
`from_config` (at a reduced size on the CPU), the batcher and `/predict`,
each answer equal to `reference()` (1e-5: a padded bucket against the
exact batch, f32).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.configs import get_config as jax_get_config
from deepvision_tpu.core.steps import _normalize_input
from deepvision_tpu.models.vit import ViT as JaxViT
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.steps import normalize_input
from deepvision_tpu_torch.models import build_model
from deepvision_tpu_torch.models.resnet import BottleneckBlock, ResNet
from deepvision_tpu_torch.models.vit import ViT
from deepvision_tpu_torch.serve.batcher import (Draining, DynamicBatcher,
                                                 result_within)
from deepvision_tpu_torch.serve.engine import PredictEngine
from deepvision_tpu_torch.serve.metrics import ServingMetrics
from deepvision_tpu_torch.serve.server import InferenceServer
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from test_torch_zoo_oracle import check_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BF16_BOUND = 1e-1


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bridged():
    """vit_tiny weights from Flax init (naive attention: the JAX side's
    attention is pinned by tests/test_torch_attention.py), the JAX apply
    fn, and an engine of the port on the CPU serving the same weights."""
    torch.set_num_threads(1)
    jcfg = jax_get_config("vit_tiny")
    kwargs = {**jcfg.model_kwargs, "attention_impl": "naive"}
    jax_model = JaxViT(num_classes=jcfg.data.num_classes,
                       dtype=jnp.dtype(jcfg.dtype), **kwargs)
    params = jax.device_get(jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
    cfg = get_config("vit_tiny")
    shell = ViT(num_classes=cfg.data.num_classes, image_size=32,
                **cfg.model_kwargs)
    engine = PredictEngine.from_config(
        "vit_tiny", device="cpu", buckets=(1, 4),
        state_dict=params_to_state_dict(params, shell), verbose=False)
    return jax_model, params, engine


def _images(n, seed=0):
    return (np.random.RandomState(seed).rand(n, 32, 32, 3)
            .astype(np.float32) * 2 - 1)


def test_engine_pads_and_strips_row_for_row(bridged):
    _, _, engine = bridged
    assert engine.buckets == (1, 4)
    x = _images(5)
    for n in range(1, 6):   # 5 runs as one max_batch chunk plus a tail
        got = engine.predict(x[:n])
        assert got.shape == (n, 10) and got.dtype == np.float32
        np.testing.assert_allclose(got, engine.reference(x[:n]),
                                   rtol=1e-6, atol=1e-6)


def test_engine_matches_jax_normalize_and_apply(bridged):
    jax_model, params, engine = bridged
    x = _images(3, seed=1)
    want = np.asarray(jax_model.apply(
        {"params": params},
        _normalize_input(jnp.asarray(x), None, jnp.bfloat16))
    ).astype(np.float32)
    assert np.abs(engine.predict(x) - want).max() <= JAX_BF16_BOUND


def test_normalize_input_matches_jax_on_uint8_pixels():
    x = np.random.RandomState(2).randint(0, 256, (2, 4, 4, 3)).astype(np.uint8)
    norm = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    want = np.asarray(_normalize_input(jnp.asarray(x), norm, jnp.float32))
    got = normalize_input(torch.from_numpy(x), norm, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _request(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_roundtrip_answers_the_engine_reference(bridged):
    _, _, engine = bridged
    srv = InferenceServer(engine=engine, max_delay_ms=3.0, flush_every_s=60)
    t = threading.Thread(target=lambda: srv.serve(port=0), daemon=True)
    t.start()
    assert srv.ready.wait(60)
    try:
        base = f"http://127.0.0.1:{srv.bound_port}"
        x = _images(3, seed=3)
        code, body = _request(f"{base}/predict/vit_tiny",
                              {"instances": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(np.asarray(body["predictions"]),
                                   engine.reference(x), rtol=1e-6, atol=1e-6)
        code, health = _request(f"{base}/healthz")
        assert code == 200 and health["device"] == "cpu"
        assert health["models"]["vit_tiny"]["device"] == "cpu"
        assert _request(f"{base}/predict/resnet50",
                        {"instances": x.tolist()})[0] == 404
        assert _request(f"{base}/predict", {"instances": [[1.0]]})[0] == 400
        code, stats = _request(f"{base}/stats")
        assert code == 200 and stats["requests"] >= 1
    finally:
        srv.stop()
        t.join(timeout=60)
        srv.close()
    assert not t.is_alive()


def test_serve_cli_smoke_on_cpu_exits_0():
    proc = subprocess.run(
        [sys.executable, "-m", "deepvision_tpu_torch.serve", "-m", "vit_tiny",
         "--smoke", "--device", "cpu", "--duration", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["serve_smoke"] == "pass" and summary["device"] == "cpu"


def test_engine_serves_lenet5_from_its_config():
    """from_config("lenet5") on the CPU (it used to raise: only ViT had
    cast_compute_weights_): f32 answers equal to the model's own eval
    forward on the same seeded weights, padding included."""
    engine = PredictEngine.from_config("lenet5", device="cpu",
                                       buckets=(1, 4), verbose=False)
    assert engine.example_shape == (32, 32, 1)
    x = np.random.RandomState(3).rand(3, 32, 32, 1).astype(np.float32)
    own = build_model(get_config("lenet5")).eval()
    with torch.no_grad():
        want = own(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(engine.reference(x), want)
    np.testing.assert_allclose(engine.predict(x), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_engine_serves_a_reduced_resnet50(dtype):
    """The ResNet-50 block structure at stages (1, 1, 1, 1), width 8, 32
    px: the bf16 convs' weights cast once, the BatchNorms and the head
    kept f32."""
    model = ResNet((1, 1, 1, 1), BottleneckBlock, num_classes=10, width=8,
                   dtype=dtype, generator=torch.Generator().manual_seed(0))
    check_engine(model, 32)
    convs = [m.weight.dtype for m in model.modules()
             if type(m).__name__ == "Conv"]
    assert set(convs) == {dtype}
    assert model.head.weight.dtype == torch.float32
    assert all(p.dtype == torch.float32 for n, p in model.named_parameters()
               if "BatchNorm" in n)


# every classification config whose engine no other test builds at full
# size (the zoo's files do theirs; lenet5 and vit_tiny above)
OTHER_CLASSIFICATION = ["lenet5_digits", "resnet34", "resnet50", "resnet101",
                        "resnet152", "resnet50v2", "resnet50_tpu",
                        "vit_small"]


@pytest.mark.parametrize("name", OTHER_CLASSIFICATION)
def test_engine_serves_every_classification_config(name):
    """from_config on the CPU at the config's own size: one image padded
    to the bucket of 2 answers what the exact batch of 1 answers, within
    2e-2 of the largest logit. The CPU blocks a GEMM of 197 rows (batch 1)
    otherwise than one of 394, so vit_small's bf16 activations round
    otherwise over its 8 blocks: 6.6e-3 of the largest logit here."""
    engine = PredictEngine.from_config(name, device="cpu", buckets=(2,),
                                       verbose=False)
    x = np.random.RandomState(6).rand(1, *engine.example_shape).astype(
        np.float32)
    got, want = engine.predict(x), engine.reference(x)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_every_classification_config_has_a_serving_test():
    from deepvision_tpu_torch.utils.registry import CONFIGS
    zoo = {"alexnet1", "alexnet2", "vgg16", "vgg19", "inception_v1",
           "inception_v3", "mobilenet_v1", "shufflenet_v1"}
    covered = zoo | {"lenet5", "vit_tiny"} | set(OTHER_CLASSIFICATION)
    assert covered == {name for name in CONFIGS._entries
                       if get_config(name).family == "classification"}


def test_serve_cli_smoke_serves_lenet5_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "deepvision_tpu_torch.serve", "-m", "lenet5",
         "--smoke", "--device", "cpu", "--duration", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["serve_smoke"] == "pass" and summary["model"] == "lenet5"


def test_engine_without_a_device_raises_when_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictEngine.from_config("vit_tiny", verbose=False)


class _EchoEngine:
    """Stand-in engine answering 2x its input rows, so each request's rows
    are recognisable after coalescing."""
    name = "echo"
    max_batch = 8
    buckets = (1, 8)
    example_shape = (2,)
    precision = "bf16"

    def _coerce(self, images):
        x = np.asarray(images, np.float32)
        return x[None] if x.ndim == 1 else x

    def predict(self, images):
        return images * 2.0

    def dispatch(self, images, generation=None, precision=None):
        """The batcher's call: the answer, the weight generation that
        computed it and that generation's provenance (one generation)."""
        return self.predict(images), "live", {}


def test_batcher_under_contention_answers_every_row_to_its_owner():
    """16 clients on one dispatcher with a 10 µs switch interval: every
    request gets exactly its own rows back, the pending count returns to 0,
    and a drain racing further submits still answers every request it
    accepted."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    metrics = ServingMetrics()
    batcher = DynamicBatcher(_EchoEngine(), max_delay_ms=1.0, metrics=metrics)
    wrong, accepted = [], []

    def client(i):
        for j in range(40):
            x = np.full((1 + (i + j) % 3, 2), i * 1000 + j, np.float32)
            if not np.array_equal(result_within(batcher.submit(x), 10.0),
                                  2 * x):
                wrong.append((i, j))

    def late_client():
        for _ in range(500):
            try:
                accepted.append(batcher.submit(np.ones((1, 2))))
            except Draining:
                return

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not wrong and batcher.queue_depth == 0
        assert metrics.snapshot()["requests"] == 16 * 40
        late = [threading.Thread(target=late_client) for _ in range(8)]
        for t in late:
            t.start()
        time.sleep(0.01)
        assert batcher.drain(timeout=30)
        for t in late:
            t.join(timeout=30)
        assert accepted and not any(t.is_alive() for t in late)
        for fut in accepted:   # a request lost behind the stop token would
            result_within(fut, 5.0)   # raise DeadlineExpired here
    finally:
        sys.setswitchinterval(old)
        batcher.drain(timeout=10)


# -- detection serving -------------------------------------------------------

YOLO_TINY = dict(num_classes=2, width_mult=0.125, stage_blocks=(1, 1, 2, 2, 1))
YOLO_SIZE = 64


@pytest.fixture(scope="module")
def yolo_bridged():
    """A tiny f32 yolov3 (2 classes, 64 px) with seeded Flax weights, the
    JAX model, and an engine of the port serving the same weights on the
    CPU at buckets (1, 4)."""
    from deepvision_tpu.models.yolo import YoloV3 as JaxYoloV3
    from deepvision_tpu_torch.models.yolo import YoloV3
    from test_torch_yolo import flax_yolo_variables

    torch.set_num_threads(1)
    x = _yolo_images(2)
    jax_model = JaxYoloV3(**YOLO_TINY, dtype=jnp.float32)
    params, stats = flax_yolo_variables(jax_model, x)
    model = YoloV3(**YOLO_TINY, dtype=torch.float32)
    model.load_state_dict(params_to_state_dict(params, model, stats))
    engine = PredictEngine(model, example_shape=(YOLO_SIZE, YOLO_SIZE, 3),
                           device="cpu", buckets=(1, 4),
                           take_first_output=False, name="yolov3_tiny",
                           verbose=False)
    return jax_model, {"params": params, "batch_stats": stats}, engine


def _yolo_images(n, seed=0):
    return (np.random.RandomState(seed).rand(n, YOLO_SIZE, YOLO_SIZE, 3)
            .astype(np.float32) * 2 - 1)


def _tree_shapes(tree):
    return [[np.shape(leaf) for leaf in scale] for scale in tree]


def test_detection_engine_serves_the_decoded_scales(yolo_bridged):
    """Three scales of (boxes_xywh, objectness, class_probs), f32, equal
    to `reference()` row for row at every padding, and to the JAX model's
    decoded apply on the same weights within 1e-4 of each leaf's largest
    value (f32: only conv summation orders differ)."""
    jax_model, variables, engine = yolo_bridged
    x = _yolo_images(6, seed=1)
    ref = engine.reference(x)
    assert _tree_shapes(ref) == [[(6, g, g, 3, 4), (6, g, g, 3, 1),
                                  (6, g, g, 3, 2)] for g in (8, 4, 2)]
    for n in (1, 3, 6):         # 6: one max_batch chunk of 4 plus a tail
        got = engine.predict(x[:n])
        assert _tree_shapes(got) == _tree_shapes(
            engine.reference(x[:n]))
        for g3, r3 in zip(got, engine.reference(x[:n])):
            for g, r in zip(g3, r3):
                assert g.dtype == np.float32
                np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
    apply = jax.jit(functools.partial(jax_model.apply, train=False))
    want = apply(variables, jnp.asarray(x))
    for g3, w3 in zip(ref, want):
        for g, w in zip(g3, w3):
            w = np.asarray(w, np.float32)
            assert np.abs(g - w).max() <= 1e-4 * max(1.0, np.abs(w).max())


def test_tree_helpers_slice_and_join_every_leaf():
    from deepvision_tpu_torch.serve.engine import tree_concat, tree_slice
    tree = (np.arange(6).reshape(3, 2), (np.arange(3), np.arange(9)
                                         .reshape(3, 3)))
    part = tree_slice(tree, 1, 3)
    assert part[0].tolist() == [[2, 3], [4, 5]]
    assert part[1][0].tolist() == [1, 2] and part[1][1].shape == (2, 3)
    whole = tree_concat([tree_slice(tree, 0, 1), part])
    assert isinstance(whole, tuple) and isinstance(whole[1], tuple)
    for a, b in zip((whole[0], *whole[1]), (tree[0], *tree[1])):
        np.testing.assert_array_equal(a, b)


class _TreeEngine(_EchoEngine):
    """Stand-in engine answering a two-level tree of its rows and counting
    the rows of each dispatch."""

    def __init__(self):
        self.dispatched = []

    def predict(self, images):
        self.dispatched.append(len(images))
        return (images * 2.0, (images * 3.0, images[:, :1]))


def test_batcher_splits_a_coalesced_tree_per_request():
    engine = _TreeEngine()
    batcher = DynamicBatcher(engine, max_delay_ms=300.0)
    xs = [np.full((n, 2), 10.0 * i, np.float32)
          for i, n in enumerate((1, 3, 2), start=1)]
    try:
        futures = [batcher.submit(x) for x in xs]
        answers = [result_within(f, 30.0) for f in futures]
    finally:
        assert batcher.drain(timeout=30)
    assert engine.dispatched == [6]          # one coalesced dispatch
    for x, (a, (b, c)) in zip(xs, answers):
        np.testing.assert_array_equal(a, 2 * x)
        np.testing.assert_array_equal(b, 3 * x)
        np.testing.assert_array_equal(c, x[:, :1])


def test_http_predict_answers_nested_lists_of_the_scales(yolo_bridged):
    _, _, engine = yolo_bridged
    srv = InferenceServer(engine=engine, max_delay_ms=3.0, flush_every_s=60)
    t = threading.Thread(target=lambda: srv.serve(port=0), daemon=True)
    t.start()
    assert srv.ready.wait(60)
    try:
        x = _yolo_images(2, seed=4)
        code, body = _request(f"http://127.0.0.1:{srv.bound_port}/predict",
                              {"instances": x.tolist()})
    finally:
        srv.stop()
        t.join(timeout=60)
        srv.close()
    assert code == 200 and body["model"] == "yolov3_tiny"
    ref = engine.reference(x)
    got = body["predictions"]
    assert len(got) == 3 and all(len(scale) == 3 for scale in got)
    for g3, r3 in zip(got, ref):
        for g, r in zip(g3, r3):
            np.testing.assert_allclose(np.asarray(g, np.float32), r,
                                       rtol=1e-6, atol=1e-6)


def test_from_config_serves_detection_and_refuses_other_families(
        monkeypatch):
    engine = PredictEngine.from_config("yolov3_digits", device="cpu",
                                       buckets=(1,), verbose=False)
    assert not engine.take_first_output and engine.example_shape == (128,
                                                                      128, 3)
    out = engine.predict(np.random.RandomState(0).rand(1, 128, 128, 3))
    assert _tree_shapes(out) == [[(1, g, g, 3, 4), (1, g, g, 3, 1),
                                  (1, g, g, 3, 10)] for g in (16, 8, 4)]
    with pytest.raises(KeyError, match="'no_such_config'"):
        PredictEngine.from_config("no_such_config", device="cpu",
                                  verbose=False)
    with pytest.raises(ValueError, match="'dcgan' is adversarial"):
        PredictEngine.from_config("dcgan", device="cpu", verbose=False)
    from deepvision_tpu_torch.serve import engine as engine_mod
    other = get_config("yolov3_digits").replace(name="other",
                                                family="other")
    monkeypatch.setattr(engine_mod, "get_config", lambda name: other)
    with pytest.raises(ValueError, match="'other' is other"):
        PredictEngine.from_config("other", device="cpu", verbose=False)


def test_tree_helpers_keep_the_keys_of_a_tuple_of_dicts():
    """CenterNet's output tree, a dict of heads per stack, through
    tree_slice, tree_concat and the server's JSON encoding."""
    from deepvision_tpu_torch.serve.engine import (tree_concat, tree_map,
                                                   tree_slice)
    rs = np.random.RandomState(3)
    tree = tuple({"heatmap": rs.rand(3, 4, 4, 2), "size": rs.rand(3, 4, 4, 2),
                  "offset": rs.rand(3, 4, 4, 2)} for _ in range(2))
    part = tree_slice(tree, 1, 3)
    assert isinstance(part, tuple) and len(part) == 2
    assert [list(d) for d in part] == [["heatmap", "size", "offset"]] * 2
    np.testing.assert_array_equal(part[1]["size"], tree[1]["size"][1:3])
    whole = tree_concat([tree_slice(tree, 0, 1), part])
    for w, t in zip(whole, tree):
        for k in t:
            np.testing.assert_array_equal(w[k], t[k])
    sent = json.loads(json.dumps(tree_map(lambda a: np.asarray(a).tolist(),
                                          part)))
    assert [sorted(d) for d in sent] == [["heatmap", "offset", "size"]] * 2
    np.testing.assert_array_equal(np.asarray(sent[0]["offset"]),
                                  part[0]["offset"])


SERVED_TREES = {"centernet": dict(num_stack=2, order=2, width_mult=1 / 16),
                "hourglass104": dict(num_stack=2, order=2, width_mult=1 / 16)}


def _reduced_engine(monkeypatch, name):
    """`from_config(name)` on the CPU at 32 px with the tiny model: the
    config's own family, classes and dtype (bf16)."""
    from deepvision_tpu_torch.serve import engine as engine_mod
    cfg = get_config(name)
    reduced = cfg.replace(model_kwargs=SERVED_TREES[name], data=dataclasses.
                          replace(cfg.data, image_size=32))
    monkeypatch.setattr(engine_mod, "get_config", lambda n: reduced)
    return PredictEngine.from_config(name, device="cpu", buckets=(1, 4),
                                     verbose=False)


def _close_trees(got, want, tol=1e-5):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _close_trees(got[k], want[k], tol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_trees(g, w, tol)
    else:
        g = np.asarray(got, np.float32)
        assert g.shape == want.shape and want.dtype == np.float32
        assert np.abs(g - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("name", sorted(SERVED_TREES))
def test_pose_and_centernet_serve_their_whole_trees(monkeypatch, name):
    engine = _reduced_engine(monkeypatch, name)
    assert not engine.take_first_output
    rs = np.random.RandomState(5)
    x = rs.rand(6, 32, 32, 3).astype(np.float32) * 2 - 1
    ref = engine.reference(x)
    assert isinstance(ref, tuple) and len(ref) == 2
    if name == "centernet":
        assert [{k: v.shape for k, v in d.items()} for d in ref] == [{
            "heatmap": (6, 8, 8, 80), "size": (6, 8, 8, 2),
            "offset": (6, 8, 8, 2)}] * 2
    else:
        assert [h.shape for h in ref] == [(6, 8, 8, 16)] * 2
    for n in (1, 3, 6):         # 6: one max_batch chunk of 4 plus a tail
        _close_trees(engine.predict(x[:n]), engine.reference(x[:n]))
    batcher = DynamicBatcher(engine, max_delay_ms=200.0)
    try:
        futures = [batcher.submit(x[lo:hi]) for lo, hi in ((0, 1), (1, 3))]
        answers = [result_within(f, 60.0) for f in futures]
    finally:
        assert batcher.drain(timeout=60)
    for (lo, hi), a in zip(((0, 1), (1, 3)), answers):
        _close_trees(a, engine.reference(x[lo:hi]))
    srv = InferenceServer(engine=engine, max_delay_ms=3.0, flush_every_s=60)
    t = threading.Thread(target=lambda: srv.serve(port=0), daemon=True)
    t.start()
    assert srv.ready.wait(60)
    try:
        code, body = _request(f"http://127.0.0.1:{srv.bound_port}/predict",
                              {"instances": x[:2].tolist()})
    finally:
        srv.stop()
        t.join(timeout=60)
        srv.close()
    assert code == 200 and body["model"] == name
    _close_trees(body["predictions"], engine.reference(x[:2]))
