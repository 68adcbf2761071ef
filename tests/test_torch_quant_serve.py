"""int8 serving in the port's stack (serve/quantize.py's `arm_int8` and the
engine's, batcher's, server's, reload's, promotion's and CLI's int8 axis)
held to the JAX package's serve/quantize.py, through the shim and the
serve stand-in of tests/test_torch_quant.py::jax_quant_modules.

- The decision records of `arm_int8` on twin lenet5 engines (the same
  filled weights, the same pinned shard, one calibration of 64 examples):
  `int8_enabled`, `refused_regression` under the fault, and
  `refused_plan` (a vit_tiny config whose head dims cover every
  projection) carry JAX's keys, decisions, plan and byte counts (the
  port adds `weight_bytes_staged`); the watched metrics within one
  example of 64 (equal here).
- A GAN config and centernet_digits raise ValueError.
- A swap, a staged candidate and its promotion, and a hot reload through
  the promotion gate (the path the flywheel's swaps take: its controller
  hands each candidate to a reloader's `check_once`) serve the new
  generation at int8, equal to that generation's own int8 reference,
  with `calibrate.passes` where arming left it.
- Batches never mix precisions; over HTTP, the per-request override, 400
  for an unknown or unarmed precision, /healthz and /stats `precision`
  and `quant`, and /metrics with its int8 series passing both packages'
  `validate_serve_exposition`.
- The CLI: `--quant-gate -1` exits 2, the two int8 flags are accepted
  (they were refused by name until this slice), and `--serve-precision
  int8` arms every model before traffic; the fault's environment parses
  as JAX's does.
"""

import copy
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.obs.export import \
    validate_serve_exposition as jax_validate
from deepvision_tpu.utils.faults import FaultInjector as JaxFaultInjector
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.metrics import MetricsLogger
from deepvision_tpu_torch.obs.export import validate_serve_exposition
from deepvision_tpu_torch.ops import quant
from deepvision_tpu_torch.serve import cli as serve_cli
from deepvision_tpu_torch.serve.batcher import DynamicBatcher
from deepvision_tpu_torch.serve.engine import PredictEngine
from deepvision_tpu_torch.serve.fleet import ModelFleet
from deepvision_tpu_torch.serve.promote import (PROMOTED,
                                                attach_promoters)
from deepvision_tpu_torch.serve.quantize import arm_int8
from deepvision_tpu_torch.serve.reload import WeightReloader
from deepvision_tpu_torch.serve.server import InferenceServer
from deepvision_tpu_torch.utils.faults import FaultInjector
from test_torch_promote import _port_epoch
from test_torch_quant import jax_quant_modules, twins


@pytest.fixture(scope="module")
def jq():
    with jax_quant_modules("engine") as mods:
        yield mods


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _imgs(engine, n, seed=0):
    return np.random.RandomState(seed).rand(
        n, *engine.example_shape).astype(engine.input_dtype)


def jax_engine(jq, name, model_kwargs=None):
    """The JAX engine and the port's on the same filled weights."""
    jax_model, variables, jcfg, engine, cfg = twins(
        name, model_kwargs=model_kwargs)
    jengine = jq.engine.PredictEngine(
        jax_model.apply, variables,
        example_shape=engine.example_shape, buckets=(1, 4),
        compute_dtype=jnp.dtype(jcfg.dtype) if jcfg.dtype else jnp.bfloat16,
        take_first_output=True, name=name, verbose=False)
    return jengine, engine, jcfg, cfg


def _records_agree(got, want):
    assert set(got) == set(want) | {"weight_bytes_staged"}
    for key in ("decision", "watch", "gate", "calibration_examples",
                "quantized_eqns", "plan", "weight_bytes_bf16",
                "weight_bytes_int8"):
        assert got[key] == want[key], key
    for key in ("metric_bf16", "metric_int8", "delta"):
        assert abs(got[key] - want[key]) <= 1.0 / 64 + 1e-9, key


@pytest.fixture(scope="module")
def lenet_pair(jq):
    return jax_engine(jq, "lenet5")


def test_arm_records_equal_jax(jq, lenet_pair):
    jengine, engine, _, _ = lenet_pair
    want = jq.quantize.arm_int8(jengine, verbose=False,
                                faults=JaxFaultInjector())
    got = arm_int8(engine, verbose=False, faults=FaultInjector())
    assert got["decision"] == "int8_enabled"
    _records_agree(got, want)
    assert got["weight_bytes_bf16"] >= 1.8 * got["weight_bytes_int8"]
    assert engine.precision == "int8" and engine.int8_enabled
    x = _imgs(engine, 4)
    out_b = engine.predict(x, precision="bf16")
    out_q = engine.predict(x)
    assert out_q.dtype == np.float32
    np.testing.assert_array_equal(out_b.argmax(-1), out_q.argmax(-1))
    assert not np.array_equal(out_b, out_q)
    assert engine.weight_bytes_per_chip()["int8"] < \
        engine.weight_bytes_per_chip()["bf16"]


def test_fault_refuses_and_bf16_keeps_serving(jq, tmp_path):
    jengine, engine, _, _ = jax_engine(jq, "lenet5")
    x = _imgs(engine, 2)
    before = engine.predict(x)
    want = jq.quantize.arm_int8(jengine, verbose=False,
                                faults=JaxFaultInjector(quant_regress=True))
    logger = MetricsLogger(str(tmp_path), name="serve")
    got = arm_int8(engine, logger=logger, verbose=False,
                   faults=FaultInjector(quant_regress=True))
    logger.close()
    assert got["decision"] == want["decision"] == "refused_regression"
    _records_agree(got, want)
    assert engine.precision == "bf16" and not engine.int8_enabled
    assert engine.quant_decision is got
    np.testing.assert_array_equal(engine.predict(x), before)
    with pytest.raises(ValueError, match="not armed"):
        engine.predict(x, precision="int8")
    assert "resilience_quant_refused" in (tmp_path / "serve.jsonl").read_text()


def test_refused_plan_records_equal_jax(jq):
    """A vit_tiny config whose head dims hold the embedding width: every
    projection is a head, attention stays, the plan refuses by name."""
    jengine, engine, jcfg, cfg = jax_engine(
        jq, "vit_tiny", {"attention_impl": "interpret"})
    width = cfg.model_kwargs["embed_dim"]
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_classes=width))
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data,
                                                 num_classes=width))
    want = jq.quantize.arm_int8(jengine, jcfg, examples=8, verbose=False,
                                faults=JaxFaultInjector())
    got = arm_int8(engine, cfg, examples=8, verbose=False,
                   faults=FaultInjector())
    assert got["decision"] == want["decision"] == "refused_plan"
    assert set(got) == set(want)
    assert got["reason"] == want["reason"] \
        == "attention_projections_unquantizable"
    assert got["detail"] == want["detail"]
    assert engine.precision == "bf16" and not engine.int8_enabled


def test_gan_and_centernet_raise():
    engine = PredictEngine.from_config("lenet5", device="cpu", buckets=(1,),
                                       verbose=False)
    with pytest.raises(ValueError, match="no predict-side watch metric"):
        arm_int8(engine, get_config("dcgan"), verbose=False)
    centernet = PredictEngine.from_config("centernet_digits", device="cpu",
                                          buckets=(1,), verbose=False)
    with pytest.raises(ValueError, match="nothing to quantize"):
        arm_int8(centernet, verbose=False, faults=FaultInjector())
    assert not centernet.int8_enabled


def _scaled(engine, scale):
    """An unstaged f32 copy of the engine's live weights, scaled."""
    model = copy.deepcopy(engine.model).float()
    for name, p in model.named_parameters():
        p.data = engine._masters[name].clone() * scale
    return model


def _int8_reference(engine, model, x):
    """`model`'s own int8 answer under `engine`'s quantizer: a fresh
    engine of that generation armed with it (no calibration)."""
    other = PredictEngine(model, example_shape=engine.example_shape,
                          device="cpu", buckets=engine.buckets,
                          name=engine.name, verbose=False)
    other.enable_int8(engine._quantizer)
    return other.predict(x, precision="int8")


def test_generations_at_int8_take_one_calibration():
    engine = PredictEngine.from_config("lenet5", device="cpu",
                                       buckets=(1, 4), verbose=False)
    arm_int8(engine, verbose=False, faults=FaultInjector())
    passes = quant.calibrate.passes
    x = _imgs(engine, 2, seed=1)
    out0 = engine.predict(x)
    new = _scaled(engine, 1.03)
    want = _int8_reference(engine, copy.deepcopy(new), x)
    engine.swap_variables(new)
    out1 = engine.predict(x)
    assert not np.array_equal(out0, out1)
    np.testing.assert_array_equal(out1, want)
    cand = _scaled(engine, 1.07)
    want = _int8_reference(engine, copy.deepcopy(cand), x)
    engine.stage_candidate(cand)
    got = engine.predict(x, generation="candidate")
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, out1)
    engine.promote_candidate()
    np.testing.assert_array_equal(engine.predict(x), want)
    assert quant.calibrate.passes == passes


@pytest.mark.parametrize("race", ["swap_while_arming",
                                  "rearm_while_swapping"])
def test_arming_racing_a_swap_serves_the_live_generation(race):
    """A swap that lands while enable_int8 quantizes, or an arming that
    lands while a swap quantizes: int8 then serves the new live
    generation's own int8 weights, never those of the one it replaced."""
    engine = PredictEngine.from_config("lenet5", device="cpu",
                                       buckets=(1, 4), verbose=False)
    arm_int8(engine, verbose=False, faults=FaultInjector())
    quantizer = engine._quantizer
    x = _imgs(engine, 2, seed=5)
    new = _scaled(engine, 1.05)
    want = _int8_reference(engine, copy.deepcopy(new), x)
    quantize, calls = engine._quantize, []

    def interleaved(q, masters):
        calls.append(q)
        if len(calls) == 1:     # the other thread's step lands here
            if race == "swap_while_arming":
                engine.swap_variables(new)
            else:
                engine.disable_int8()
                engine.enable_int8(copy.copy(quantizer))
        return quantize(q, masters)

    engine._quantize = interleaved
    if race == "swap_while_arming":
        engine.disable_int8()
        engine.enable_int8(quantizer)
    else:
        engine.swap_variables(new)
    np.testing.assert_array_equal(engine.predict(x, precision="int8"), want)


def test_hot_reload_through_the_gate_requantizes(tmp_path):
    """Epoch 2 lands in the served run dir: the reloader verifies it and
    the promotion controller shadow-scores it at int8, canaries and
    promotes it; int8 then serves epoch 2's own int8 answer, with no
    calibration."""
    wd = str(tmp_path / "lenet5")
    _port_epoch(wd, 1)
    engine = PredictEngine.from_config("lenet5", device="cpu", workdir=wd,
                                       buckets=(1, 4), verbose=False)
    arm_int8(engine, verbose=False, faults=FaultInjector())
    passes = quant.calibrate.passes
    fleet = ModelFleet()
    sm = fleet.add(engine, workdir=wd, max_delay_ms=1.0)
    attach_promoters(fleet, gate_min_delta=-1.0, canary_frac=0.5,
                     canary_window_s=0.0)
    reloader = WeightReloader(fleet, poll_every_s=0)
    try:
        _port_epoch(wd, 2, 1.05)
        assert reloader.check_once() == 1
        assert sm.promoter.history[-1]["decision"] == PROMOTED
        assert engine.provenance["checkpoint_epoch"] == 2
        x = _imgs(engine, 2, seed=3)
        fresh = PredictEngine.from_config("lenet5", device="cpu",
                                          workdir=wd, checkpoint=2,
                                          buckets=(1, 4), verbose=False)
        fresh.enable_int8(engine._quantizer)
        np.testing.assert_array_equal(engine.predict(x),
                                      fresh.predict(x, precision="int8"))
        assert engine.precision == "int8"
        assert quant.calibrate.passes == passes
    finally:
        fleet.drain(timeout=30)


def test_batches_never_mix_precisions():
    engine = PredictEngine.from_config("lenet5", device="cpu",
                                       buckets=(1, 4), verbose=False)
    arm_int8(engine, verbose=False, faults=FaultInjector())
    batcher = DynamicBatcher(engine, max_delay_ms=20.0)
    try:
        xs = [_imgs(engine, 1, seed=i) for i in range(8)]
        futs = [(batcher.submit(x, precision=("int8" if i % 2 else "bf16")),
                 x, "int8" if i % 2 else "bf16")
                for i, x in enumerate(xs)]
        for fut, x, precision in futs:
            np.testing.assert_array_equal(
                np.asarray(fut.result(timeout=60)),
                engine.predict(x, precision=precision))
        with pytest.raises(ValueError, match="unknown precision"):
            batcher.submit(xs[0], precision="fp4")
    finally:
        batcher.drain(timeout=30)
    assert engine.dispatches_by_precision["int8"] > 0


def _serve(fleet):
    srv = InferenceServer(fleet=fleet, flush_every_s=60.0)
    th = threading.Thread(target=srv.serve, kwargs={"port": 0}, daemon=True)
    th.start()
    assert srv.ready.wait(120)
    return srv, th, f"http://127.0.0.1:{srv.bound_port}"


def _post(base, body):
    req = urllib.request.Request(
        base + "/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return json.load(urllib.request.urlopen(req, timeout=60))


def test_http_precision_override_healthz_and_metrics():
    fleet = ModelFleet()
    fleet.add(PredictEngine.from_config("lenet5", device="cpu",
                                        buckets=(1, 4), verbose=False),
              max_delay_ms=5.0)
    fleet.add(PredictEngine.from_config("lenet5_digits", device="cpu",
                                        buckets=(1,), verbose=False),
              max_delay_ms=5.0)
    engine = fleet.default.engine
    arm_int8(engine, verbose=False, faults=FaultInjector())
    srv, th, base = _serve(fleet)
    try:
        x = _imgs(engine, 1).tolist()
        default = _post(base, {"instances": x})
        forced_bf16 = _post(base, {"instances": x, "precision": "bf16"})
        forced_int8 = _post(base, {"instances": x, "precision": "int8"})
        assert default["predictions"] == forced_int8["predictions"]
        assert forced_bf16["predictions"] != forced_int8["predictions"]
        for body, path in (({"instances": x, "precision": "fp4"},
                            "/predict"),
                           ({"instances": x, "precision": "int8"},
                            "/predict/lenet5_digits")):
            req = urllib.request.Request(
                base + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=60)
            assert ei.value.code == 400
        health = json.load(urllib.request.urlopen(base + "/healthz",
                                                  timeout=60))
        assert health["precision"] == "int8"
        assert health["quant"]["decision"] == "int8_enabled"
        assert health["models"]["lenet5"]["precision"] == "int8"
        assert health["models"]["lenet5_digits"]["precision"] == "bf16"
        assert health["models"]["lenet5_digits"]["quant"] is None
        stats = json.load(urllib.request.urlopen(base + "/stats",
                                                 timeout=60))
        assert stats["precision"] == "int8"
        metrics = urllib.request.urlopen(base + "/metrics",
                                         timeout=60).read().decode()
        assert validate_serve_exposition(metrics) == []
        assert jax_validate(metrics) == []
        assert 'precision="int8"' in metrics
        assert ('deepvision_serve_active_precision'
                '{model="lenet5",precision="int8"} 1') in metrics
        assert ('deepvision_serve_weight_bytes_per_chip'
                '{model="lenet5",precision="int8"}') in metrics
    finally:
        srv.stop()
        th.join(timeout=60)
        assert not th.is_alive()
        srv.close()


@pytest.mark.parametrize("flag,value", [("--serve-precision", "int8"),
                                        ("--quant-gate", "0.05")])
def test_int8_flags_accepted(flag, value):
    """The two int8 flags, refused by name until int8 serving came, parse
    and validate (tests/test_torch_serve_ops.py's later-flags cases)."""
    parser = serve_cli.build_parser()
    args = parser.parse_args(["-m", "lenet5", "--device", "cpu", flag,
                              value])
    serve_cli.validate_args(parser, args)
    assert str(getattr(args, flag[2:].replace("-", "_"))) == value


def test_cli_quant_gate_and_arming_before_traffic(capsys):
    with pytest.raises(SystemExit) as ei:
        serve_cli.main(["-m", "lenet5", "--device", "cpu", "--quant-gate",
                        "-1", "--smoke"])
    assert ei.value.code == 2
    with pytest.raises(SystemExit):
        serve_cli.build_parser().parse_args(
            ["-m", "lenet5", "--serve-precision", "fp8"])
    parser = serve_cli.build_parser()
    args = parser.parse_args(["-m", "lenet5,centernet_digits", "--device",
                              "cpu", "--buckets", "1",
                              "--serve-precision", "int8"])
    serve_cli.validate_args(parser, args)
    server = serve_cli.build_server(args)
    try:
        lenet = server.fleet.get("lenet5").engine
        assert lenet.precision == "int8"
        assert lenet.quant_decision["decision"] == "int8_enabled"
        assert server.fleet.get("centernet_digits").engine.precision \
            == "bf16"
        assert "int8 skipped: nothing to quantize" in capsys.readouterr().out
    finally:
        server.close()


@pytest.mark.parametrize("value", ["1", "0", "", "yes"])
def test_quant_fault_env_equals_jax(value):
    env = {"DEEPVISION_FAULT_QUANT_REGRESS": value}
    got, want = FaultInjector.from_env(env), JaxFaultInjector.from_env(env)
    assert got.quant_regression() == want.quant_regression()
    assert got.active == want.active
