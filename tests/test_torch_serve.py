"""Port serving stack (deepvision_tpu_torch/serve/) on the CPU.

The engine pads and strips buckets without touching real rows, answers what
the JAX package's `_normalize_input` + `ViT.apply` answer on the same
(bridged) weights, and the HTTP front door answers the engine's own
reference logits. The bf16 bound against JAX, 1e-1 on logits of scale ~2,
covers bf16 activation roundings compounding over vit_tiny's 4 blocks.
"""

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
from deepvision_tpu_torch.models.vit import ViT
from deepvision_tpu_torch.serve.batcher import (Draining, DynamicBatcher,
                                                 result_within)
from deepvision_tpu_torch.serve.engine import PredictEngine
from deepvision_tpu_torch.serve.metrics import ServingMetrics
from deepvision_tpu_torch.serve.server import InferenceServer
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict

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

    def _coerce(self, images):
        x = np.asarray(images, np.float32)
        return x[None] if x.ndim == 1 else x

    def predict(self, images):
        return images * 2.0


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
