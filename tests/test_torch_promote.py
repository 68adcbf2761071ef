"""Weight generations, scoring, accuracy-gated promotion and hot reload of
the port (deepvision_tpu_torch/serve/{engine,promote,reload}.py,
core/scoring.py), held to the JAX package's own code on the same inputs.

The JAX controllers are the oracle: `PromotionController` and
`WeightReloader` loaded from their files through the stand-in package of
tests/test_torch_serve_ops.py::jax_serve_modules, run on a JAX engine
while the port's run on a port engine, both serving the same lenet5
weights (the Flax init carried across by utils/flax_convert.py) on the
same pinned shard. What is held equal:

- `pinned_shard` byte for byte for every served config, at uint8 and f32;
- `score_serving_outputs` on the same output trees, one per family
  (exactly; the trees are numpy, made from a seed);
- the shadow scores of both generations: equal, or apart by at most
  (argmax disagreements) / examples where the two engines' top-2 logits
  sit at a tie (each disagreeing row's top-2 margin below 1e-5; lenet5 is
  f32 on both sides);
- the promotion decisions: promoted, refused by the gate with
  DEEPVISION_FAULT_PROMOTE_REGRESS=k:accuracy armed, rolled back in the
  canary with ...=k:latency, and the refusal cached by the reloader (the
  epoch scored exactly once);
- the keys of `POST /reload`'s answer and of its reload record.

The port's own contracts beside them: two generations in one engine
(stage, promote, drop; a refused signature; no generation mixed in a
batch; vit_tiny's generation switch through ops/attention.py's plain
version, counted), hot reload under concurrent HTTP traffic with every
answer equal to one generation's reference, the corrupt, incompatible and
missing-manifest candidates, the CLI's promotion flags, and SIGTERM
during a canary rolling back and exiting 0.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deepvision_tpu.configs import get_config as jax_get_config
from deepvision_tpu.core import scoring as jax_scoring
from deepvision_tpu.utils.faults import FaultInjector as JaxFaultInjector
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core import integrity, scoring
from deepvision_tpu_torch.core.trainer import Trainer
from deepvision_tpu_torch.models import build_model
from deepvision_tpu_torch.models.lenet import LeNet5
from deepvision_tpu_torch.ops import attention as attention_ops
from deepvision_tpu_torch.serve.batcher import DynamicBatcher, result_within
from deepvision_tpu_torch.serve.engine import PredictEngine
from deepvision_tpu_torch.serve.fleet import ModelFleet
from deepvision_tpu_torch.serve.promote import PromotionController
from deepvision_tpu_torch.serve.reload import WeightReloader
from deepvision_tpu_torch.serve.server import InferenceServer
from deepvision_tpu_torch.utils import registry
from deepvision_tpu_torch.utils.faults import FaultInjector
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from test_torch_serve_ops import jax_serve_modules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = (32, 32, 1)
TIE_MARGIN = 1e-5        # top-2 logit margin under which argmaxes may part


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_serve():
    with jax_serve_modules("engine", "fleet", "promote", "reload",
                           "server") as mods:
        yield mods


def _imgs(n, seed=0):
    return np.random.RandomState(seed).randn(n, *SAMPLE).astype(np.float32)


def _scaled_lenet(state_dict, scale):
    model = LeNet5()
    model.load_state_dict({k: v * scale for k, v in state_dict.items()})
    return model


# -- the pinned shard and the scores -------------------------------------------

SERVED = [name for name, cfg in registry.CONFIGS.items()
          if cfg.family != "gan"]


@pytest.mark.parametrize("name", SERVED)
def test_pinned_shard_byte_equal_to_jax(name):
    """The shadow shard of every served config, at uint8 and f32: the same
    bytes as the JAX package's (images and every target array)."""
    cfg, jcfg = get_config(name), jax_get_config(name)
    size = min(cfg.data.image_size, 96)
    for dtype in (np.uint8, np.float32):
        got = scoring.pinned_shard(cfg, image_size=size, input_dtype=dtype,
                                   examples=6)
        want = jax_scoring.pinned_shard(jcfg, image_size=size,
                                        input_dtype=dtype, examples=6)
        assert got[0].dtype == want[0].dtype == np.dtype(dtype)
        assert got[0].tobytes() == want[0].tobytes()
        assert len(got[1]) == len(want[1])
        for a, b in zip(got[1], want[1]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert scoring.watch_metric_name(cfg) == \
        jax_scoring.watch_metric_name(jcfg)
    assert scoring.serving_head_dims(cfg) == \
        jax_scoring.serving_head_dims(jcfg)


def _outputs(name, targets, rs):
    """A serving output tree of `name`'s family, made from numpy."""
    cfg = get_config(name)
    n = len(targets[0])
    nc = cfg.data.num_classes
    if cfg.family == "classification":
        return rs.randn(n, nc).astype(np.float32)
    if cfg.family == "segmentation":
        return rs.randint(0, nc, (n, 16, 16)).astype(np.int32)
    if cfg.family == "detection":
        return tuple((rs.rand(n, g, g, 3, 4).astype(np.float32),
                      rs.rand(n, g, g, 3, 1).astype(np.float32),
                      rs.rand(n, g, g, 3, nc).astype(np.float32))
                     for g in (4, 2, 1))
    if cfg.family == "centernet":
        return [{"heatmap": (rs.randn(n, 8, 8, nc) - 1.0).astype(
                    np.float32),
                 "size": rs.rand(n, 8, 8, 2).astype(np.float32),
                 "offset": rs.rand(n, 8, 8, 2).astype(np.float32)}
                for _ in range(2)]
    return [rs.rand(n, 8, 8, nc).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("name", ["lenet5", "unet_synthetic",
                                  "yolov3_digits", "centernet_digits",
                                  "hourglass104"])
def test_score_serving_outputs_equal_jax(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    _, targets = scoring.pinned_shard(cfg, image_size=16,
                                      input_dtype=np.float32, examples=12)
    if cfg.family == "segmentation":
        targets = (targets[0][:, :16, :16],)
    for seed in range(3):
        out = _outputs(name, targets, np.random.RandomState(seed))
        got = scoring.score_serving_outputs(cfg, out, targets)
        want = jax_scoring.score_serving_outputs(jcfg, out, targets)
        assert got == want, (name, seed)
        assert 0.0 <= got <= 1.0


def test_input_moments_and_shift_equal_jax():
    x = np.random.RandomState(0).rand(4, 8, 8, 3)
    got, want = scoring.input_moments(x), jax_scoring.input_moments(x)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert scoring.moment_shift(*got, got[0] + 0.5, got[1]) == \
        jax_scoring.moment_shift(*want, want[0] + 0.5, want[1])


# -- the engine's two generations -------------------------------------------------

def test_engine_hosts_two_generations():
    engine = PredictEngine.from_config("lenet5", device="cpu",
                                       buckets=(1, 4), verbose=False)
    x = _imgs(2, seed=1)
    sd = {k: v.clone() for k, v in engine.model.state_dict().items()}
    live_ptrs = [p.data_ptr() for p in engine.model.parameters()]
    assert not engine.has_candidate
    engine.stage_candidate(_scaled_lenet(sd, 1.1),
                           {"checkpoint_epoch": 2, "verified": True})
    out_live = engine.predict(x)
    out_cand = engine.predict(x, generation="candidate")
    assert not np.allclose(out_live, out_cand)
    # a padded bucket against the exact batch: 1e-5 (f32)
    np.testing.assert_allclose(out_cand,
                               engine.reference(x, generation="candidate"),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown weight generation"):
        engine.predict(x, generation="blue")
    # the live module was never written: a candidate is its own module
    assert [p.data_ptr() for p in engine.model.parameters()] == live_ptrs
    engine.promote_candidate()
    assert not engine.has_candidate
    assert engine.provenance["checkpoint_epoch"] == 2
    np.testing.assert_array_equal(engine.predict(x), out_cand)
    engine.stage_candidate(_scaled_lenet(sd, 2.0))
    engine.drop_candidate()
    np.testing.assert_array_equal(engine.predict(x, generation="candidate"),
                                  out_cand)
    assert engine.dispatches_by_generation == {"live": 3, "candidate": 1}
    cfg = get_config("lenet5")
    other = cfg.replace(data=dataclasses.replace(cfg.data, num_classes=5))
    with pytest.raises(ValueError, match="architecture"):
        engine.stage_candidate(build_model(other))
    assert not engine.has_candidate


def test_batcher_never_mixes_generations():
    engine = PredictEngine.from_config("lenet5", device="cpu",
                                       buckets=(1, 8), verbose=False)
    engine.stage_candidate(_scaled_lenet(
        {k: v.clone() for k, v in engine.model.state_dict().items()}, 1.2))
    batches = []
    b = DynamicBatcher(engine, max_delay_ms=20.0, workers=2)
    b.observer = (lambda gen, lats, disp, err, sample=None:
                  batches.append((gen, len(lats), err)))
    try:
        x = _imgs(1, seed=3)
        ref = {"live": engine.reference(x),
               "candidate": engine.reference(x, generation="candidate")}
        futs = [(g, b.submit(x, generation=None if g == "live" else g))
                for g in ["live", "candidate"] * 8]
        for g, fut in futs:
            np.testing.assert_allclose(result_within(fut, 60.0), ref[g],
                                       rtol=1e-5, atol=1e-6)
    finally:
        assert b.drain(timeout=30)
    assert sum(n for _, n, _ in batches) == 16
    assert {g for g, _, _ in batches} == {"live", "candidate"}
    assert all(err is None for _, _, err in batches)


def test_vit_tiny_generation_switch_runs_attention_counted(monkeypatch):
    """vit_tiny's two generations both go through ops/attention.py (its
    plain version on the CPU, counted here as the kernel counts its
    launches): depth x dispatches of each generation."""
    calls = {"n": 0}
    plain = attention_ops.flash_attention_reference

    def counted(*args, **kwargs):
        calls["n"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(attention_ops, "flash_attention_reference", counted)
    cfg = get_config("vit_tiny")
    engine = PredictEngine.from_config("vit_tiny", device="cpu",
                                       buckets=(1, 4), verbose=False)
    cand = build_model(cfg)
    cand.load_state_dict({k: v.float() * 1.01 for k, v in
                          engine.model.state_dict().items()})
    engine.stage_candidate(cand, {"checkpoint_epoch": 2})
    x = np.random.RandomState(0).randn(
        3, *engine.example_shape).astype(engine.input_dtype)
    calls["n"] = 0
    engine.dispatches = 0
    live = engine.predict(x)
    new = engine.predict(x, generation="candidate")
    depth = cfg.model_kwargs["depth"]
    assert calls["n"] == depth * engine.dispatches == 2 * depth
    assert np.isfinite(live).all() and not np.allclose(live, new)


# -- promotion decisions against the JAX controller --------------------------------

@pytest.fixture(scope="module")
def twin_engines(jax_serve):
    """A JAX engine and a port engine on the same lenet5 weights (the JAX
    engine's seeded init, carried across), and each side's candidate
    maker: the live weights scaled."""
    jeng = jax_serve.engine.PredictEngine.from_config(
        "lenet5", buckets=(1, 4), verbose=False)
    params = jax.device_get(jeng._variables["params"])
    sd = params_to_state_dict(params, LeNet5())
    peng = PredictEngine.from_config("lenet5", device="cpu",
                                     buckets=(1, 4), state_dict=sd,
                                     verbose=False)

    def jcand(scale):
        return {"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a) * scale, params)}

    return jeng, peng, jcand, lambda scale: _scaled_lenet(sd, scale)


def _controllers(jax_serve, twin_engines, **kw):
    jeng, peng, _, _ = twin_engines
    jfleet, pfleet = jax_serve.fleet.ModelFleet(), ModelFleet()
    jsm = jfleet.add(jeng, max_delay_ms=1.0)
    psm = pfleet.add(peng, max_delay_ms=1.0)
    jctl = jax_serve.promote.PromotionController(jsm, **kw)
    pctl = PromotionController(psm, **kw)
    return (jfleet, jsm, jctl), (pfleet, psm, pctl)


def _top2_margin(logits):
    top = np.sort(logits, axis=-1)
    return top[:, -1] - top[:, -2]


def test_shadow_scores_equal_jax(jax_serve, twin_engines):
    jeng, peng, jcand, pcand = twin_engines
    (jfleet, _, jctl), (pfleet, _, pctl) = _controllers(
        jax_serve, twin_engines, canary_window_s=0.0)
    try:
        images, targets = pctl._eval_shard()
        jimages, _ = jctl._eval_shard()
        assert images.tobytes() == jimages.tobytes()
        jeng.stage_candidate(jcand(1.05))
        peng.stage_candidate(pcand(1.05))
        worst = 0.0
        for gen in (None, "candidate"):
            got, want = pctl._score(gen), jctl._score(gen)
            a = peng.predict(images, generation=gen)
            b = np.asarray(jeng.predict(images, generation=gen))
            apart = np.argmax(a, -1) != np.argmax(b, -1)
            if apart.any():
                worst = max(worst, float(_top2_margin(b)[apart].max()))
            assert worst < TIE_MARGIN, worst
            assert abs(got - want) <= apart.sum() / len(images) + 1e-12
        print(f"largest top-2 margin at a disagreeing argmax: {worst:g}")
    finally:
        jeng.drop_candidate()
        peng.drop_candidate()
        jfleet.drain(timeout=30)
        pfleet.drain(timeout=30)


def _traffic(sm, stop, x):
    while not stop.is_set():
        result_within(sm.submit(x), 60.0)


def test_promotion_decisions_equal_jax(jax_serve, twin_engines):
    """The same candidates through both controllers: a clean one promoted
    (no canary traffic: the gate decides), one with the accuracy fault
    refused by the gate, one with the latency fault rolled back in the
    canary under traffic — the same decision at every step."""
    jeng, peng, jcand, pcand = twin_engines
    (jfleet, jsm, jctl), (pfleet, psm, pctl) = _controllers(
        jax_serve, twin_engines, canary_window_s=0.0, canary_frac=0.5)
    decisions = []
    try:
        for epoch, fault, window in ((2, None, 0.0), (3, "accuracy", 0.0),
                                     (4, "latency", 0.6)):
            out = []
            for ctl, sm, cand, inj in (
                    (jctl, jsm, jcand, JaxFaultInjector),
                    (pctl, psm, pcand, FaultInjector)):
                ctl.faults = inj(promote_regress_epoch=epoch,
                                 promote_regress_kind=fault)
                ctl.canary_window_s = window
                stop = threading.Event()
                clients = [threading.Thread(target=_traffic, daemon=True,
                                            args=(sm, stop, _imgs(1)))
                           for _ in range(3 if window else 0)]
                for c in clients:
                    c.start()
                try:
                    out.append(ctl.propose(epoch, cand(1.0 + epoch / 100),
                                           {"checkpoint_epoch": epoch}))
                finally:
                    stop.set()
                    for c in clients:
                        c.join(timeout=60)
            decisions.append(out)
    finally:
        jfleet.drain(timeout=30)
        pfleet.drain(timeout=30)
    assert decisions == [["promoted"] * 2, ["refused_gate"] * 2,
                         ["rolled_back_canary"] * 2]
    for ctl in (jctl, pctl):
        assert [r["decision"] for r in ctl.history] == [
            "promoted", "refused_gate", "rolled_back_canary"]
        assert ctl.history[1]["metric_delta"] < ctl.gate_min_delta
        assert ctl.history[2]["canary_requests"] > 0
    assert peng.provenance["checkpoint_epoch"] == 2
    assert not peng.has_candidate and not jeng.has_candidate


# -- the reloader and POST /reload against the JAX ones ------------------------------

def _port_epoch(workdir, epoch, scale=1.0, fault_env=None):
    """Commit one manifested lenet5 checkpoint as the port's training
    does: seeded weights, scaled."""
    tr = Trainer(get_config("lenet5"), device="cpu", workdir=workdir)
    try:
        tr.init_state()
        with torch.no_grad():
            for p in tr.state.model.parameters():
                p.mul_(scale)
        if fault_env is not None:
            tr.ckpt.fault_injector = FaultInjector.from_env(fault_env)
        tr.ckpt.save(epoch, tr.state.state_dict(),
                     host_state={"best_metric": 0.0})
        tr.ckpt.flush()
    finally:
        tr.close()


def _jax_epoch(workdir, epoch, scale=1.0):
    from deepvision_tpu.configs import trainer_class_for_config
    tr = trainer_class_for_config("lenet5")(jax_get_config("lenet5"),
                                            workdir=workdir)
    try:
        tr.init_state(SAMPLE)
        st = tr.state.replace(params=jax.tree_util.tree_map(
            lambda a: a * scale, tr.state.params))
        tr.ckpt.save(epoch, st, {"best_metric": 0.0})
        tr.ckpt.flush()
    finally:
        tr.close()


def _post_reload(base):
    req = urllib.request.Request(base + "/reload", data=b"",
                                 method="POST")
    return json.load(urllib.request.urlopen(req, timeout=120))


def test_refusal_cached_and_reload_outcomes_equal_jax(jax_serve, tmp_path):
    """Both servers, each on its own run dir: epoch 2 with the accuracy
    fault armed is refused by the gate and cached (scored once, a second
    sweep scores nothing), a clean epoch 3 is promoted past it; `POST
    /reload` answers the same keys and the same reload record."""
    outcomes = {}
    for side in ("jax", "port"):
        wd = str(tmp_path / side / "lenet5")
        save = _jax_epoch if side == "jax" else _port_epoch
        save(wd, 1)
        if side == "jax":
            engine = jax_serve.engine.PredictEngine.from_config(
                "lenet5", workdir=wd, buckets=(1, 4), verbose=False)
            fleet = jax_serve.fleet.ModelFleet()
            server_cls = jax_serve.server.InferenceServer
            inj = JaxFaultInjector
        else:
            engine = PredictEngine.from_config(
                "lenet5", device="cpu", workdir=wd, buckets=(1, 4),
                verbose=False)
            fleet = ModelFleet()
            server_cls = InferenceServer
            inj = FaultInjector
        fleet.add(engine, workdir=wd, max_delay_ms=1.0)
        srv = server_cls(fleet=fleet, flush_every_s=60.0,
                         promote_gate=-0.02, canary_window_s=0.0)
        sm = fleet.default
        sm.promoter.faults = inj(promote_regress_epoch=2,
                                 promote_regress_kind="accuracy")
        th = threading.Thread(target=srv.serve, kwargs={"port": 0},
                              daemon=True)
        th.start()
        try:
            assert srv.ready.wait(120)
            base = f"http://127.0.0.1:{srv.bound_port}"
            save(wd, 2, 1.05)
            first = _post_reload(base)
            evals = sm.promoter.shadow_evals
            second = _post_reload(base)
            cached = sm.promoter.shadow_evals == evals
            save(wd, 3, 1.1)
            third = _post_reload(base)
        finally:
            srv.stop()
            th.join(timeout=60)
            srv.close()
        outcomes[side] = {
            "keys": sorted(first),
            "reload_keys": sorted(first["models"]["lenet5"]["reload"]),
            "swapped": [r["swapped"] for r in (first, second, third)],
            "reload": [{k: v for k, v in
                        r["models"]["lenet5"]["reload"].items()
                        if k != "last_reload_unix"}    # a wall-clock time
                       for r in (first, second, third)],
            "decisions": [d["decision"] for d in third["models"]["lenet5"]
                          ["promotion"]["decisions"]],
            "epoch": third["models"]["lenet5"]["weights"][
                "checkpoint_epoch"],
            "cached": cached,
            "watched": first["watched"],
        }
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"]["swapped"] == [0, 0, 1]
    assert outcomes["port"]["decisions"] == ["refused_gate", "promoted"]
    assert outcomes["port"]["cached"] and outcomes["port"]["epoch"] == 3


# -- hot reload under traffic, refused candidates -------------------------------------

def test_hot_reload_under_concurrent_traffic(tmp_path):
    """Clients hammer /predict while epoch 2 lands and swaps in (the
    poller, not a POST): no failed request, every answer equal to one
    generation's reference and labeled with its epoch, provenance at 2."""
    wd = str(tmp_path / "lenet5")
    _port_epoch(wd, 1)
    engine = PredictEngine.from_config("lenet5", device="cpu", workdir=wd,
                                       buckets=(1, 4), verbose=False)
    fleet = ModelFleet()
    fleet.add(engine, workdir=wd, max_delay_ms=2.0, workers=2)
    srv = InferenceServer(fleet=fleet, flush_every_s=60.0,
                          reload_every_s=0.05)
    x = _imgs(1, seed=7)
    ref = {1: engine.reference(x)}
    th = threading.Thread(target=srv.serve, kwargs={"port": 0}, daemon=True)
    th.start()
    stop = threading.Event()
    results, failures = [], []

    def client():
        body = json.dumps({"instances": x.tolist()}).encode()
        while not stop.is_set():
            try:
                out = json.load(urllib.request.urlopen(
                    urllib.request.Request(base + "/predict/lenet5",
                                           data=body), timeout=60))
                results.append((out["weights_epoch"],
                                np.asarray(out["predictions"], np.float32)))
            except Exception as e:  # noqa: BLE001 — every failure counts
                failures.append(e)
                return

    try:
        assert srv.ready.wait(60)
        base = f"http://127.0.0.1:{srv.bound_port}"
        clients = [threading.Thread(target=client, daemon=True)
                   for _ in range(4)]
        for c in clients:
            c.start()
        time.sleep(0.3)
        _port_epoch(wd, 2, 1.05)
        deadline = time.monotonic() + 120
        while engine.provenance.get("checkpoint_epoch") != 2 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        health = json.load(urllib.request.urlopen(base + "/healthz",
                                                  timeout=30))
        assert health["models"]["lenet5"]["weights"]["checkpoint_epoch"] == 2
        assert health["models"]["lenet5"]["weights"]["verified"] is True
        assert health["models"]["lenet5"]["reload"]["reloads"] == 1
        time.sleep(0.3)
    finally:
        stop.set()
        for c in clients:
            c.join(timeout=60)
        srv.stop()
        th.join(timeout=60)
        srv.close()
    assert not failures, failures[:3]
    ref[2] = engine.reference(x)
    assert not np.allclose(ref[1], ref[2])
    seen = {1: 0, 2: 0}
    for epoch, out in results:
        np.testing.assert_allclose(out, ref[epoch], rtol=1e-5, atol=1e-6)
        seen[epoch] += 1
    assert seen[1] > 0 and seen[2] > 0, seen


def test_corrupt_incompatible_and_missing_manifest_candidates(tmp_path):
    """A bit-flipped epoch is refused as corrupt (cached, logged to the
    resilience stream); an epoch of another architecture is refused as
    incompatible; an epoch without its manifest waits (not refused) and
    swaps in once the manifest lands. The old weights serve throughout."""
    wd = str(tmp_path / "lenet5")
    _port_epoch(wd, 1)
    engine = PredictEngine.from_config("lenet5", device="cpu", workdir=wd,
                                       buckets=(1, 4), verbose=False)
    fleet = ModelFleet()
    sm = fleet.add(engine, workdir=wd, max_delay_ms=1.0)
    from deepvision_tpu_torch.core.metrics import MetricsLogger
    logger = MetricsLogger(str(tmp_path / "logs"), name="serve")
    reloader = WeightReloader(fleet, poll_every_s=0, logger=logger)
    x = _imgs(2)
    before = engine.predict(x)
    try:
        _port_epoch(wd, 2, 1.05,
                    fault_env={"DEEPVISION_FAULT_CKPT_CORRUPT": "2:bitflip"})
        assert reloader.check_once() == 0
        assert sm.reload_stats["refused_corrupt"] == 1
        assert reloader.check_once() == 0           # cached: not re-hashed
        assert sm.reload_stats["refused_corrupt"] == 1
        assert logger.history["resilience_reload_refused_corrupt"][
            "value"] == [1.0]
        # another architecture's checkpoint in the same run dir
        tr = Trainer(get_config("lenet5"), device="cpu", workdir=wd)
        try:
            tr.init_state()
            state = tr.state.state_dict()
            first = next(iter(state["model"]))
            state["model"][first] = torch.zeros(
                (3, *state["model"][first].shape[1:]))
            tr.ckpt.save(3, state, host_state={"best_metric": 0.0})
            tr.ckpt.flush()
        finally:
            tr.close()
        assert reloader.check_once() == 0
        assert sm.reload_stats["refused_incompatible"] == 1
        # a committed epoch whose manifest is not written yet waits (the
        # writer commits the manifest after the data), then swaps in
        _port_epoch(wd, 4, 1.1)
        manifest = os.path.join(wd, "ckpt", "4", integrity.MANIFEST_NAME)
        os.rename(manifest, manifest + ".later")
        assert integrity.verify_epoch(os.path.join(wd, "ckpt"), 4)[0] == \
            integrity.MISSING_MANIFEST
        assert reloader.check_once() == 0
        assert sm.reload_stats["refused_corrupt"] \
            + sm.reload_stats["refused_incompatible"] == 2
        np.testing.assert_array_equal(engine.predict(x), before)
        os.rename(manifest + ".later", manifest)
        assert reloader.check_once() == 1
        assert engine.provenance["checkpoint_epoch"] == 4
        assert not np.allclose(engine.predict(x), before)
    finally:
        fleet.drain(timeout=30)
        logger.close()


# -- the CLI ---------------------------------------------------------------------------

def test_promote_cli_flag_contract():
    from deepvision_tpu_torch.serve.cli import main
    for argv in (["-m", "lenet5", "--promote-gate", "-0.02"],
                 ["-m", "lenet5", "--reload-every", "1",
                  "--canary-frac", "1.5"],
                 ["-m", "lenet5", "--reload-every", "-1"]):
        with pytest.raises(SystemExit) as ei:
            main(argv + ["--device", "cpu"])
        assert ei.value.code == 2


def test_sigterm_mid_canary_rolls_back_and_drains_exit0(tmp_path):
    """The serve CLI with the gate and a long canary: epoch 2 lands, the
    canary starts under traffic, SIGTERM arrives mid-canary — the
    candidate rolls back to the incumbent (rolled_back_abort), every
    accepted request is answered, and the process exits 0."""
    wd = str(tmp_path / "lenet5")
    _port_epoch(wd, 1)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepvision_tpu_torch.serve", "-m", "lenet5",
         "--device", "cpu", "--workdir", wd, "--reload-every", "0.1",
         "--promote-gate", "-0.02", "--canary-frac", "0.5",
         "--canary-window", "60", "--buckets", "1,4", "--port", str(port),
         "--flush-every", "60"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                urllib.request.urlopen(base + "/healthz", timeout=5)
                break
            except OSError:
                assert time.monotonic() < deadline and proc.poll() is None
                time.sleep(0.1)
        _port_epoch(wd, 2, 1.05)
        body = json.dumps({"instances": _imgs(1).tolist()}).encode()
        state = None
        while state != "canary":
            assert time.monotonic() < deadline
            urllib.request.urlopen(urllib.request.Request(
                base + "/predict", data=body), timeout=30)
            state = json.load(urllib.request.urlopen(
                base + "/healthz", timeout=30))["models"]["lenet5"][
                    "promotion"]["state"]
        answered = 0
        for _ in range(3):
            out = json.load(urllib.request.urlopen(urllib.request.Request(
                base + "/predict", data=body), timeout=30))
            answered += out["generation"] in ("live", "candidate")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-3000:]
    assert answered == 3
    assert "rolled_back_abort" in out and "drained cleanly" in out


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
