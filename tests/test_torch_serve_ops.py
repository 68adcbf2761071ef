"""The port's serving operations (deepvision_tpu_torch/obs/ and the serve
stack's metrics, faults, breaker, autoscaler and HTTP surface) held to the
JAX package's own code on the same inputs.

The JAX serve modules cannot be imported the usual way on this tree (the
package's `__init__` reaches `ops/quant.py`'s `jax.core` import), but each
loads from its own file unchanged once a bare module stands in for the
`deepvision_tpu.serve` package: `jax_serve_modules` installs that stand-in
in `sys.modules` for the duration of a fixture and, when the fixture ends,
puts back every `deepvision_tpu.serve*` entry exactly as it was, so no JAX
test sharing the worker process sees a different `deepvision_tpu.serve`.
tests/test_torch_promote.py and tests/test_torch_chip_smoke_serve_ops.py
import the helper from here.

Oracles (each with the tolerance it states): the tracer's sampling
decisions and the `chrome_trace` documents (equal once timestamps and the
process name are aligned); the Prometheus text of one port fleet rendered
by both `render_prometheus` (equal parsed samples) and the port's
`/metrics` passing JAX's `validate_serve_exposition`; `ServingMetrics` fed
one `observe_*` sequence (equal totals, histograms and snapshot keys; the
rates within 1e-9 relative); the breaker and autoscaler under a fake clock
and scripted metrics (equal decision sequences); `FaultInjector.from_env`
on the same environments, malformed ones included (equal fields and error
types). The HTTP contracts of tests/test_{autoscale,obs,serve_fleet}.py run
on the port's server.
"""

import contextlib
import importlib
import json
import os
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from deepvision_tpu.obs import export as jax_export
from deepvision_tpu.obs import trace as jax_trace
from deepvision_tpu.utils import faults as jax_faults
from deepvision_tpu_torch.core.metrics import MetricsLogger
from deepvision_tpu_torch.core.resilience import log_resilience_event
from deepvision_tpu_torch.obs import export, trace
from deepvision_tpu_torch.serve import autoscale
from deepvision_tpu_torch.serve.batcher import (CircuitOpen, DeadlineExpired,
                                                 DynamicBatcher,
                                                 RequestRejected,
                                                 result_within)
from deepvision_tpu_torch.serve.cli import main as serve_main
from deepvision_tpu_torch.serve.engine import PredictEngine
from deepvision_tpu_torch.serve.fleet import ModelFleet
from deepvision_tpu_torch.serve.metrics import ServingMetrics
from deepvision_tpu_torch.serve.server import InferenceServer
from deepvision_tpu_torch.utils import faults

SAMPLE = (32, 32, 1)
SERVE_PKG = "deepvision_tpu.serve"


@contextlib.contextmanager
def jax_serve_modules(*names):
    """The JAX package's `deepvision_tpu/serve/<name>.py` modules, loaded
    from their files under a bare stand-in for the `deepvision_tpu.serve`
    package (a `types.ModuleType` whose `__path__` is the directory), as a
    namespace. The stand-in is installed with a monkeypatch; on exit every
    `deepvision_tpu.serve*` module is restored to what it was before (the
    ones loaded here removed), so the JAX tests' view is unchanged."""
    import deepvision_tpu
    root = os.path.join(os.path.dirname(deepvision_tpu.__file__), "serve")
    saved = {k: v for k, v in sys.modules.items()
             if k == SERVE_PKG or k.startswith(SERVE_PKG + ".")}
    stand_in = types.ModuleType(SERVE_PKG)
    stand_in.__path__ = [root]
    with pytest.MonkeyPatch.context() as mp:
        for k in saved:
            mp.delitem(sys.modules, k)
        mp.setitem(sys.modules, SERVE_PKG, stand_in)
        try:
            yield types.SimpleNamespace(**{
                n: importlib.import_module(f"{SERVE_PKG}.{n}")
                for n in names})
        finally:
            for k in [k for k in sys.modules
                      if k.startswith(SERVE_PKG + ".")]:
                del sys.modules[k]
    assert {k: v for k, v in sys.modules.items()
            if k == SERVE_PKG or k.startswith(SERVE_PKG + ".")} == saved


@pytest.fixture(scope="module")
def jax_serve():
    with jax_serve_modules("metrics", "autoscale") as mods:
        yield mods


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engine():
    torch.set_num_threads(1)
    return PredictEngine.from_config("lenet5", device="cpu", buckets=(1, 4),
                                     verbose=False)


def _imgs(n, seed=0):
    return np.random.RandomState(seed).randn(n, *SAMPLE).astype(np.float32)


def test_stand_in_leaves_the_jax_package_as_it_was():
    """The helper's isolation rule: after the block, every
    deepvision_tpu.serve* entry of sys.modules is what it was before."""
    before = {k for k in sys.modules if k.startswith(SERVE_PKG)}
    with jax_serve_modules("metrics") as mods:
        assert mods.metrics.__name__ == f"{SERVE_PKG}.metrics"
        assert f"{SERVE_PKG}.metrics" in sys.modules
    assert {k for k in sys.modules if k.startswith(SERVE_PKG)} == before


# -- tracer and Chrome trace ----------------------------------------------------

@pytest.mark.parametrize("sample", [0.0, 0.1, 0.25, 0.5, 1.0])
def test_tracer_sampling_decisions_equal_jax(sample):
    """The same request sequence (forced ids mixed in) gets the same
    sampling decisions from both tracers: deterministic 1-in-N."""
    ours, theirs = trace.Tracer(sample=sample), jax_trace.Tracer(
        sample=sample)
    seq = [("r%d" % i, i % 7 == 3) for i in range(40)]
    got = [ours.request_context(rid, forced=f) is not None
           for rid, f in seq]
    want = [theirs.request_context(rid, forced=f) is not None
            for rid, f in seq]
    assert got == want
    assert trace.DEFAULT_SAMPLE == jax_trace.DEFAULT_SAMPLE


def test_tracer_disabled_ring_bound_and_since_window():
    tr = trace.Tracer(capacity=8, enabled=False)
    assert tr.request_context("x", forced=True) is None
    assert tr.add("a", "t", 0, 1) == 0
    assert tr.spans() == []
    tr = trace.Tracer(capacity=8, sample=1.0)
    for i in range(20):
        tr.add("s", "t", i, 1)
    assert len(tr.spans()) == 8 and tr.recorded == 20
    assert tr.spans()[0]["ts"] == 12
    now = time.monotonic_ns()
    tr.add("old", "t", now - int(60e9), 1000)
    tr.add("new", "t", now, 1000)
    assert [s["name"] for s in tr.spans(since_s=5.0)] == ["new"]
    with pytest.raises(ValueError):
        trace.Tracer(sample=1.5)


def _span_script(tr):
    """One request's spans and its batch, the way the server and the
    batcher record them, relative to the tracer's origin."""
    t0 = tr.t0_ns
    ctx = tr.request_context("demo", forced=True)
    bid = tr.new_id()
    tr.add("admission", "serve", t0 + 500, 200,
           args={"request_id": "demo", "outcome": "accepted"}, tid="h")
    tr.add("queue_wait", "serve", t0 + 1000, 2000,
           args={"request_id": "demo", "batch": bid}, tid="w1")
    tr.add("batch", "serve", t0 + 2500, 5000,
           args={"bucket": 8, "generation": "live", "worker": "w1",
                 "requests": ["demo"]}, span_id=bid, tid="w1")
    tr.add("device_dispatch", "serve", t0 + 3000, 4000,
           args={"batch": bid, "generation": "live"}, tid="w1")
    tr.add("http_request", "serve", t0, 9000,
           args={"request_id": "demo", "status": 200},
           span_id=ctx.root_id, tid="h")


def test_chrome_trace_equals_jax():
    """The same span script through both tracers: equal Chrome documents
    once the timestamp origin (t0_unix) and the process name are
    aligned; the flow arrow links the queue wait to its batch."""
    ours, theirs = trace.Tracer(sample=1.0), jax_trace.Tracer(sample=1.0)
    _span_script(ours)
    _span_script(theirs)
    got, want = export.chrome_trace(ours), jax_export.chrome_trace(theirs)
    for doc in (got, want):
        doc["otherData"]["t0_unix"] = 0.0
        for e in doc["traceEvents"]:
            if e["name"] == "process_name":
                e["args"]["name"] = "process"
    assert got == want
    flows = [e for e in got["traceEvents"] if e["ph"] in ("s", "f")]
    assert {f["ph"] for f in flows} == {"s", "f"}


def test_write_chrome_trace(tmp_path):
    tr = trace.Tracer(sample=1.0)
    _span_script(tr)
    n = export.write_chrome_trace(tr, str(tmp_path / "t.json"))
    assert n == 5
    assert json.load(open(tmp_path / "t.json"))["traceEvents"]


# -- Prometheus text -------------------------------------------------------------

def test_prometheus_validators_equal_jax_on_broken_texts():
    base = "# HELP h latency\n# TYPE h histogram\n"
    texts = [
        "# HELP m_total r\n# TYPE m_total counter\nm_total{model=\"a\"} 3\n",
        'orphan_total{model="a"} 1\n',
        "# HELP bad-name x\n# TYPE bad-name counter\nbad-name 1\n",
        base + ('h_bucket{le="0.1"} 5\nh_bucket{le="1"} 3\n'
                'h_bucket{le="+Inf"} 5\nh_sum 1\nh_count 5\n'),
        base + 'h_bucket{le="0.1"} 5\nh_sum 1\nh_count 5\n',
        base + ('h_bucket{le="0.1"} 5\nh_bucket{le="+Inf"} 5\n'
                'h_sum 1\nh_count 7\n'),
    ]
    for text in texts:
        assert export.validate_prometheus_text(text) == \
            jax_export.validate_prometheus_text(text)
        assert export.parse_prometheus_text(text) == \
            jax_export.parse_prometheus_text(text)
    assert export.validate_prometheus_text(texts[0]) == []
    assert all(export.validate_prometheus_text(t) for t in texts[1:])


def test_merge_expositions_equals_jax(engine):
    fleet = ModelFleet()
    sm = fleet.add(engine, max_delay_ms=1.0)
    try:
        result_within(sm.submit(_imgs(1)), 60.0)
        text = export.render_prometheus(fleet)
    finally:
        fleet.drain(timeout=30)
    texts = {"r0": text, "r1": text}
    merged = export.merge_expositions(texts)
    assert merged == jax_export.merge_expositions(texts)
    assert export.validate_prometheus_text(merged) == []


def _traffic_fleet(engine, n_requests=3):
    fleet = ModelFleet()
    sm = fleet.add(engine, max_delay_ms=1.0)
    for i in range(n_requests):
        result_within(sm.submit(_imgs(1 + i % 3, seed=i)), 60.0)
    return fleet, sm


def test_render_prometheus_equals_jax_on_one_port_fleet(engine):
    """JAX's render_prometheus and the port's over the same port fleet
    (traffic, a breaker, reload and autoscale stats) parse to the same
    samples; both pass JAX's validate_serve_exposition and the port's."""
    fleet, sm = _traffic_fleet(engine)
    try:
        with sm.reload_lock:
            sm.reload_stats["refused_gate"] += 1
            sm.autoscale_stats["scale_ups"] += 2
        ours = export.render_prometheus(fleet)
        theirs = jax_export.render_prometheus(fleet)
    finally:
        fleet.drain(timeout=30)
    assert export.parse_prometheus_text(ours) == \
        jax_export.parse_prometheus_text(theirs)
    for text in (ours, theirs):
        assert jax_export.validate_serve_exposition(text) == []
        assert export.validate_serve_exposition(text) == []
    parsed = export.parse_prometheus_text(ours)
    assert parsed[("deepvision_serve_requests_total",
                   (("model", "lenet5"),))] == 3.0
    assert parsed[("deepvision_serve_breaker_state",
                   (("model", "lenet5"), ("state", "closed")))] == 1.0


# -- metrics ---------------------------------------------------------------------

def _observe_script(m):
    m.observe_batch(n_real=2, bucket=8, dispatch_s=0.004,
                    request_latencies_s=[0.030, 0.034],
                    queue_waits_s=[0.026, 0.030])
    m.observe_batch(n_real=5, bucket=8, dispatch_s=0.2,
                    request_latencies_s=[0.0009, 0.3, 2.0, 11.0],
                    queue_waits_s=[0.0001, 0.1, 1.9, 10.9])
    m.observe_shed()
    m.observe_admission_reject()
    m.observe_deadline_expired()
    m.observe_breaker_reject()
    m.observe_dispatch_error()
    m.observe_observer_error()
    m.observe_observer_error()


def test_serving_metrics_equal_jax(jax_serve):
    """One observe_* sequence through both accumulators: equal lifetime
    totals and histograms (exact), equal snapshot keys, the counts and
    quantiles of the snapshots exact, the rates within 1e-9 relative (two
    clocks); totals and histograms survive an interval reset."""
    ours, theirs = ServingMetrics(), jax_serve.metrics.ServingMetrics()
    _observe_script(ours)
    _observe_script(theirs)
    assert ours.totals() == theirs.totals()
    assert ours.histograms() == theirs.histograms()
    assert ours.histograms_by_precision() == \
        theirs.histograms_by_precision()
    a, b = ours.snapshot(queue_depth=3), theirs.snapshot(queue_depth=3)
    assert a.keys() == b.keys()
    for k in a:
        if k.endswith("_per_sec"):
            continue
        assert a[k] == pytest.approx(b[k], rel=1e-9), k
    ours.snapshot(reset=True)
    assert ours.totals() == theirs.totals()
    assert ours.histograms() == theirs.histograms()
    assert ours.snapshot()["requests"] == 0.0
    assert jax_serve.metrics.LATENCY_BUCKETS_S == \
        __import__("deepvision_tpu_torch.serve.metrics",
                   fromlist=["x"]).LATENCY_BUCKETS_S


# -- faults ----------------------------------------------------------------------

FAULT_ENVS = [
    {},
    {"DEEPVISION_FAULT_SERVE_DISPATCH_FAIL": "2:3"},
    {"DEEPVISION_FAULT_SERVE_DISPATCH_FAIL": "4"},
    {"DEEPVISION_FAULT_PROMOTE_REGRESS": "3:latency"},
    {"DEEPVISION_FAULT_PROMOTE_REGRESS": "5"},
    {"DEEPVISION_FAULT_PROMOTE_REGRESS": "3:speed"},
    {"DEEPVISION_FAULT_PROMOTE_REGRESS": "x:accuracy"},
    {"DEEPVISION_FAULT_SERVE_DISPATCH_FAIL": "a:1"},
    {"DEEPVISION_FAULT_SERVE_DISPATCH_FAIL": "1:b"},
    {"DEEPVISION_FAULT_SERVE_DISPATCH_FAIL": "0:2",
     "DEEPVISION_FAULT_PROMOTE_REGRESS": "7:accuracy",
     "DEEPVISION_FAULT_NAN_STEP": "3"},
]
FAULT_FIELDS = ("serve_dispatch_fail_at", "serve_dispatch_fail_count",
                "promote_regress_epoch", "promote_regress_kind",
                "nan_step", "active")


def _parse(cls, env):
    try:
        inj = cls.from_env(env)
    except Exception as e:  # noqa: BLE001 — the error type is the result
        return type(e).__name__
    fired = []
    for i in range(6):
        try:
            inj.before_serve_dispatch()
        except RuntimeError:
            fired.append(i)
    return ({f: getattr(inj, f) for f in FAULT_FIELDS}, fired,
            [inj.promote_regression(e) for e in (None, 3, 5, 7)])


@pytest.mark.parametrize("env", FAULT_ENVS, ids=lambda e: ",".join(
    f"{k.split('_FAULT_')[1]}={v}" for k, v in e.items()) or "unset")
def test_fault_env_parse_equals_jax(env):
    """The same environment through both injectors: the same parsed
    fields, the same dispatches failing, the same promotion verdicts —
    or the same error type for a malformed value."""
    assert _parse(faults.FaultInjector, env) == \
        _parse(jax_faults.FaultInjector, env)
    assert faults.PROMOTE_REGRESS_KINDS == jax_faults.PROMOTE_REGRESS_KINDS


# -- breaker and autoscaler --------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _breaker_script(module, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(module.time, "monotonic", clock)
    b = module.CircuitBreaker("m", k=3, cooldown_s=5.0)
    out = []
    for step, arg in [("record", False), ("reject", None),
                      ("record", False), ("record", True),
                      ("record", False), ("record", False),
                      ("record", False), ("reject", None), ("tick", 2.0),
                      ("reject", None), ("tick", 3.5), ("reject", None),
                      ("reject", None), ("record", False), ("reject", None),
                      ("tick", 5.1), ("reject", None), ("tick", 6.0),
                      ("reject", None), ("record", True), ("reject", None)]:
        if step == "tick":
            clock.t += arg
            continue
        if step == "record":
            b.record(ok=arg)
        else:
            wait = b.reject_for()
            out.append(None if wait is None else round(wait, 6))
        out.append(dict(b.describe()))
    return out


def test_breaker_decisions_equal_jax(jax_serve, monkeypatch):
    """A scripted outcome sequence on a fake clock: open after K=3
    consecutive errors, fail fast with the time to the probe, half-open
    after the cooldown, one probe at a time, a failed probe re-opens, a
    lost probe is replaced after a cooldown, a success closes — the same
    states, counters and waits step for step."""
    got = _breaker_script(autoscale, monkeypatch)
    want = _breaker_script(jax_serve.autoscale, monkeypatch)
    assert got == want
    states = [d["state"] for d in got if isinstance(d, dict)]
    assert {"closed", "open", "half_open"} <= set(states)
    assert got[-1]["closed_after_open"] == 1 and got[-1]["reopened"] == 1


class _ScriptedModel:
    """A ServedModel stand-in whose metrics, queue and pool the test
    scripts: the autoscaler reads only these."""

    def __init__(self, name="m"):
        self.name = name
        self.engine = types.SimpleNamespace()   # no mesh: a single card
        self._totals = {"shed": 0, "admission_rejected": 0}
        self.queue = 0
        self.pool = 1
        self.reload_lock = threading.Lock()
        self.autoscale_stats = {"scale_ups": 0, "scale_downs": 0,
                                "escalations": 0, "wants_scale_out": False}
        self.p99_bound_ms = 10.0
        self.p99 = 0.0
        model = self

        class Metrics:
            def totals(self):
                return dict(model._totals)

            def snapshot(self):
                return {"p99_ms": model.p99}

        class Batcher:
            max_batch = 4

            @property
            def queue_depth(self):
                return model.queue

            @property
            def workers(self):
                return model.pool

            def set_workers(self, n):
                model.pool = n
                return n

        self.metrics, self.batcher = Metrics(), Batcher()


AUTOSCALE_SCRIPT = (
    [("shed", 3, 0, 0.0)] * 7          # sustained shed: up, up, escalate
    + [("p99", 0, 8, 50.0)] * 3        # p99 past 2x bound with a queue
    + [("busy", 0, 2, 0.0)] * 2        # a standing queue: streaks reset
    + [("idle", 0, 0, 0.0)] * 9)       # idle: down, down


def _autoscale_script(module, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(module.time, "monotonic", clock)
    sm = _ScriptedModel()
    ctl = module.AutoscaleController([sm], interval_s=0, min_workers=1,
                                     max_workers=3, up_after=2,
                                     down_after=3, cooldown_s=1.0)
    out = []
    for kind, shed, queue, p99 in AUTOSCALE_SCRIPT:
        clock.t += 0.6
        sm._totals["shed"] += shed
        sm.queue, sm.p99 = queue, p99
        decided = ctl.check_once()
        stats = dict(sm.autoscale_stats)
        stats.pop("last_decision_unix", None)
        out.append((kind, decided, sm.pool, stats))
    return out


def test_autoscaler_decisions_equal_jax(jax_serve, monkeypatch):
    """A scripted load sequence on a fake clock: hysteresis (up after 2
    overloaded samples), the cooldown between decisions, the ceiling's
    escalation and its flag, the p99 signal, streak resets on a standing
    queue, scale-down after 3 idle samples — the same decision sequence
    from both controllers."""
    got = _autoscale_script(autoscale, monkeypatch)
    want = _autoscale_script(jax_serve.autoscale, monkeypatch)
    assert got == want
    pools = [p for _, _, p, _ in got]
    assert max(pools) == 3 and pools[-1] < 3
    assert got[-1][3]["escalations"] >= 1
    assert got[-1][3]["scale_downs"] >= 1


# -- the batcher's pool, breaker and observer ---------------------------------------

def test_breaker_open_half_open_close_cycle(engine):
    """K=3 injected dispatch errors open the circuit; an open circuit
    fail-fasts naming the model; after the cooldown one probe is
    admitted and its success closes it; a failed probe re-opens."""
    b = DynamicBatcher(engine, max_delay_ms=1.0,
                       faults=faults.FaultInjector(
                           serve_dispatch_fail_at=0,
                           serve_dispatch_fail_count=3))
    b.breaker = autoscale.CircuitBreaker("lenet5", k=3, cooldown_s=0.2)
    x = _imgs(1)
    try:
        for _ in range(3):
            with pytest.raises(RuntimeError, match="injected"):
                result_within(b.submit(x), 60.0)
        assert b.breaker.describe()["state"] == "open"
        t0 = time.perf_counter()
        with pytest.raises(CircuitOpen, match="lenet5"):
            b.submit(x)
        assert time.perf_counter() - t0 < 1.0
        time.sleep(0.25)
        out = result_within(b.submit(x), 60.0)
        np.testing.assert_allclose(out, engine.reference(x), rtol=1e-5,
                                   atol=1e-6)
        d = b.breaker.describe()
        assert d["state"] == "closed" and d["opened"] == 1 \
            and d["closed_after_open"] == 1
    finally:
        assert b.drain(timeout=30)
    b = DynamicBatcher(engine, max_delay_ms=1.0,
                       faults=faults.FaultInjector(
                           serve_dispatch_fail_at=0,
                           serve_dispatch_fail_count=2))
    b.breaker = autoscale.CircuitBreaker("lenet5", k=1, cooldown_s=0.15)
    try:
        with pytest.raises(RuntimeError, match="injected"):
            result_within(b.submit(x), 60.0)
        time.sleep(0.2)
        with pytest.raises(RuntimeError, match="injected"):
            result_within(b.submit(x), 60.0)
        assert b.breaker.describe()["reopened"] == 1
        time.sleep(0.2)
        result_within(b.submit(x), 60.0)
        assert b.breaker.describe()["state"] == "closed"
    finally:
        assert b.drain(timeout=30)


def test_pool_resizes_without_copying_weights(engine):
    """set_workers grows and shrinks the pool at batch boundaries; every
    answer is its own request's (row ownership); the engine's parameter
    storage is untouched (a worker is a thread and a reference)."""
    ptrs = [p.data_ptr() for p in engine.model.parameters()]
    b = DynamicBatcher(engine, max_delay_ms=2.0, workers=1)
    xs = [_imgs(1 + i % 3, seed=10 + i) for i in range(24)]
    try:
        assert b.set_workers(3) == 3 and b.workers == 3
        futs = [b.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            np.testing.assert_allclose(result_within(f, 60.0),
                                       engine.reference(x), rtol=1e-5,
                                       atol=1e-6)
        b.set_workers(1)
        deadline = time.monotonic() + 30
        while b.workers > 1 and time.monotonic() < deadline:
            result_within(b.submit(xs[0]), 60.0)
        assert b.workers == 1
    finally:
        assert b.drain(timeout=30)
    assert [p.data_ptr() for p in engine.model.parameters()] == ptrs


def test_observer_exceptions_counted_not_swallowed(engine):
    m = ServingMetrics()
    b = DynamicBatcher(engine, max_delay_ms=1.0, metrics=m)

    def broken(generation, latencies, dispatch_s, error, sample=None):
        raise ValueError("tap exploded")

    b.observer = broken
    x = _imgs(1)
    try:
        for _ in range(3):
            np.testing.assert_allclose(result_within(b.submit(x), 60.0),
                                       engine.reference(x), rtol=1e-5,
                                       atol=1e-6)
    finally:
        assert b.drain(timeout=30)
    assert m.totals()["observer_errors"] == 3
    assert len(b._observer_errors_seen) == 1


def test_result_within_bounds_the_wait():
    t0 = time.perf_counter()
    with pytest.raises(DeadlineExpired, match="wedged"):
        result_within(Future(), 0.05, what="unit")
    assert time.perf_counter() - t0 < 2.0


class _Paced:
    """Engine proxy with a fixed pause per dispatch (the sleep releases
    the GIL, so pool workers add real capacity on one core)."""

    def __init__(self, inner, delay_s):
        self._inner, self._delay = inner, delay_s

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def dispatch(self, images, generation=None, precision=None):
        time.sleep(self._delay)
        return self._inner.dispatch(images, generation, precision=precision)


def test_autoscaler_scales_up_on_shed_then_down_when_idle(engine):
    fleet = ModelFleet()
    sm = fleet.add(_Paced(engine, 0.02), max_delay_ms=1.0,
                   max_queue_examples=16)
    ctl = autoscale.AutoscaleController([sm], interval_s=0, min_workers=1,
                                        max_workers=3, up_after=2,
                                        down_after=3, cooldown_s=0.0)
    x = _imgs(1)
    futs, stop = [], threading.Event()

    def offer():
        while not stop.is_set():
            try:
                futs.append(sm.submit(x))
            except RequestRejected:
                pass
            time.sleep(0.003)

    t = threading.Thread(target=offer, daemon=True)
    try:
        t.start()
        time.sleep(0.3)
        assert sm.metrics.totals()["shed"] > 0
        assert ctl.check_once() == 0          # hysteresis: 1 of 2
        time.sleep(0.25)
        assert ctl.check_once() == 1 and sm.batcher.workers == 2
    finally:
        stop.set()
        t.join(timeout=30)
    for f in futs:
        with contextlib.suppress(RequestRejected):
            result_within(f, 60.0)
    for _ in range(4):
        ctl.check_once()
    assert sm.autoscale_stats["scale_downs"] >= 1
    assert sm.describe()["autoscale"]["scale_ups"] == 1
    fleet.drain(timeout=30)


# -- the HTTP surface ----------------------------------------------------------------

def _serve(fleet, tmp_path=None, **kw):
    srv = InferenceServer(fleet=fleet, flush_every_s=60.0,
                          log_dir=str(tmp_path) if tmp_path else None, **kw)
    th = threading.Thread(target=srv.serve, kwargs={"port": 0}, daemon=True)
    th.start()
    assert srv.ready.wait(120)
    return srv, th, f"http://127.0.0.1:{srv.bound_port}"


def _stop(srv, th):
    srv.stop()
    th.join(timeout=60)
    assert not th.is_alive()
    srv.close()


def _post(base, body, headers=None, path="/predict"):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=60)


def _events(tmp_path):
    return [json.loads(ln) for ln in
            (tmp_path / "serve.jsonl").read_text().splitlines()
            if "meta" not in ln]


def test_http_metrics_trace_and_request_id_roundtrip(engine, tmp_path):
    fleet = ModelFleet()
    fleet.add(engine, max_delay_ms=3.0)
    srv, th, base = _serve(fleet, tmp_path)
    try:
        x = _imgs(1)
        r = _post(base, {"instances": x.tolist()}, {"X-Request-Id": "demo"})
        assert r.status == 200 and r.headers["X-Request-Id"] == "demo"
        body = json.load(r)
        assert body["generation"] == "live" and body["model"] == "lenet5"
        assert _post(base, {"instances": x.tolist()}).headers[
            "X-Request-Id"]
        m1 = urllib.request.urlopen(base + "/metrics",
                                    timeout=60).read().decode()
        assert jax_export.validate_serve_exposition(m1) == []
        _post(base, {"instances": x.tolist()})
        m2 = urllib.request.urlopen(base + "/metrics",
                                    timeout=60).read().decode()
        p1, p2 = (export.parse_prometheus_text(m1),
                  export.parse_prometheus_text(m2))
        key = ("deepvision_serve_requests_total", (("model", "lenet5"),))
        assert p2[key] == p1[key] + 1
        for k, v in p1.items():
            if k[0].endswith("_total") or k[0].endswith("_count"):
                assert p2.get(k, v) >= v, k
        doc = json.load(urllib.request.urlopen(base + "/trace", timeout=60))
        spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        mine = [e for e in spans if e["args"].get("request_id") == "demo"]
        assert {"http_request", "admission", "queue_wait",
                "response_write"} <= {e["name"] for e in mine}
        qw = next(e for e in mine if e["name"] == "queue_wait")
        batch = next(e for e in spans if e["name"] == "batch"
                     and e["args"]["span_id"] == qw["args"]["batch"])
        assert batch["args"]["generation"] == "live"
        assert "demo" in batch["args"]["requests"]
        assert any(e["name"] == "device_dispatch"
                   and e["args"]["batch"] == batch["args"]["span_id"]
                   for e in spans)
        assert json.load(urllib.request.urlopen(
            base + "/trace?secs=60", timeout=60))["traceEvents"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/trace?secs=bogus", timeout=60)
        assert ei.value.code == 400
    finally:
        _stop(srv, th)


def test_request_ids_on_429_503_504_with_correlated_events(engine,
                                                           tmp_path):
    """Every refusal echoes its request id, and its resilience event
    carries the id and (sampled) the trace_ref of its span chain: 504
    after acceptance, 429 on a full queue, 503 while the circuit is open
    (naming the model, Retry-After), 503 draining."""
    fleet = ModelFleet()
    sm = fleet.add(_Paced(engine, 0.4), max_delay_ms=1.0,
                   max_queue_examples=2, breaker_k=1,
                   breaker_cooldown_s=30.0)
    srv, th, base = _serve(fleet, tmp_path, trace_sample=0.0)
    x = _imgs(1)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"instances": x.tolist(), "deadline_ms": 100},
                  {"X-Request-Id": "expired-1"})
        assert ei.value.code == 504
        assert ei.value.headers["X-Request-Id"] == "expired-1"
        assert json.load(ei.value)["reason"] == "deadline_expired"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"instances": _imgs(3).tolist()},
                  {"X-Request-Id": "shed-1"})
        assert ei.value.code == 429
        assert ei.value.headers["X-Request-Id"] == "shed-1"
        sm.batcher.faults = faults.FaultInjector(serve_dispatch_fail_at=0)
        time.sleep(0.5)              # the expired request's dispatch ends
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"instances": x.tolist()})     # the K-th error
        assert ei.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"instances": x.tolist()},
                  {"X-Request-Id": "open-1"})
        assert ei.value.code == 503
        assert ei.value.headers["X-Request-Id"] == "open-1"
        assert float(ei.value.headers["Retry-After"]) > 0
        body = json.load(ei.value)
        assert body["reason"] == "circuit_open" and body["model"] == "lenet5"
        assert "lenet5" in body["error"]
        sm.breaker.record(ok=True)        # a success closes the circuit
        srv.drain()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"instances": x.tolist()},
                  {"X-Request-Id": "drain-1"})
        assert ei.value.code == 503
        assert ei.value.headers["X-Request-Id"] == "drain-1"
        assert json.load(ei.value)["reason"] == "draining"
    finally:
        _stop(srv, th)
    lines = _events(tmp_path)
    for outcome, rid in (("deadline_expired", "expired-1"),
                         ("overloaded", "shed-1"),
                         ("circuit_open", "open-1"),
                         ("draining", "drain-1")):
        ev = [ln for ln in lines
              if f"resilience_serve_refused_{outcome}" in ln]
        assert len(ev) == 1 and ev[0]["request_id"] == rid, outcome
        assert ev[0]["trace_ref"].startswith("span:"), outcome
    opened = [ln for ln in lines if "resilience_breaker_opened" in ln]
    assert len(opened) == 1 and opened[0]["trace_ref"].startswith("span:")


def test_admission_503_and_deadline_504_over_http(engine):
    fleet = ModelFleet()
    fleet.add(_Paced(engine, 0.25), max_delay_ms=1.0)
    srv, th, base = _serve(fleet)
    x = _imgs(1, seed=3)
    try:
        t0 = time.perf_counter()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, {"instances": x.tolist(), "deadline_ms": 80})
        assert e.value.code == 504 and time.perf_counter() - t0 < 5.0
        time.sleep(0.5)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, {"instances": x.tolist(), "deadline_ms": 100})
        assert e.value.code == 503
        assert float(e.value.headers["Retry-After"]) > 0
        assert json.load(e.value)["reason"] == "deadline_unmeetable"
        out = json.load(_post(base, {"instances": x.tolist(),
                                     "deadline_ms": 5000}))
        np.testing.assert_allclose(np.asarray(out["predictions"],
                                              np.float32),
                                   engine.reference(x), rtol=1e-5,
                                   atol=1e-6)
        snap = json.load(urllib.request.urlopen(base + "/stats",
                                                timeout=30))
        assert snap["deadline_expired"] >= 1.0
        assert snap["admission_rejected"] >= 1.0
    finally:
        _stop(srv, th)


def test_trace_disabled_serves_empty_ring_ids_still_flow(engine):
    fleet = ModelFleet()
    fleet.add(engine, max_delay_ms=2.0)
    srv, th, base = _serve(fleet, trace=False)
    try:
        r = _post(base, {"instances": _imgs(1).tolist()},
                  {"X-Request-Id": "demo"})
        assert r.headers["X-Request-Id"] == "demo"
        doc = json.load(urllib.request.urlopen(base + "/trace", timeout=60))
        assert [e for e in doc["traceEvents"] if e.get("ph") == "X"] == []
    finally:
        _stop(srv, th)


def test_healthz_carries_workers_breaker_and_autoscale(engine):
    fleet = ModelFleet()
    fleet.add(engine, max_delay_ms=2.0, workers=2)
    srv, th, base = _serve(fleet)
    try:
        h = json.load(urllib.request.urlopen(base + "/healthz", timeout=60))
        rec = h["models"]["lenet5"]
        assert h["status"] == "ok" and rec["workers"] == 2
        assert rec["breaker"]["state"] == "closed"
        assert rec["autoscale"]["workers"] == 2
        assert rec["promotion"] is None and rec["hot_reload"] is False
    finally:
        _stop(srv, th)


def test_resilience_event_carries_request_id_and_trace_ref(tmp_path):
    logger = MetricsLogger(str(tmp_path), name="serve")
    log_resilience_event(logger, 1, {"serve_refused_draining": 1.0},
                         request_id="demo", trace_ref="span:7")
    log_resilience_event(logger, 2, {"plain_event": 1.0})
    logger.close()
    lines = _events(tmp_path)
    ev = next(ln for ln in lines if "resilience_serve_refused_draining" in ln)
    assert ev["request_id"] == "demo" and ev["trace_ref"] == "span:7"
    plain = next(ln for ln in lines if "resilience_plain_event" in ln)
    assert "request_id" not in plain and "trace_ref" not in plain


# -- the CLI ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["-m", "lenet5", "--workers", "0"],
    ["-m", "lenet5", "--workers", "3", "--max-workers", "2"],
    ["-m", "lenet5", "--deadline-ms", "0"],
    ["-m", "lenet5", "--breaker-k", "0"],
    ["-m", "lenet5", "--breaker-cooldown", "0"],
    ["-m", "lenet5", "--trace-sample", "1.5"],
    ["-m", "lenet5", "--drain-grace", "-1"],
    ["-m", "lenet5", "--autoscale-every", "-1"],
    ["-m", "lenet5", "--promote-gate", "-0.02"],
    ["-m", "lenet5", "--canary-frac", "0"],
    ["-m", "lenet5", "--canary-window", "-1"],
    ["-m", "lenet5,lenet5_digits", "--workdir", "x"],
    ["-m", "lenet5,lenet5_digits", "-c", "1", "--runs-root", "x"],
])
def test_cli_flag_contract(argv):
    with pytest.raises(SystemExit) as ei:
        serve_main(argv + ["--device", "cpu"])
    assert ei.value.code == 2


@pytest.mark.parametrize("flag,value,slice_", [
    ("--model-parallel", "2", "mesh serving"),
    ("--spatial-parallel", "2", "mesh serving"),
    ("--hbm-gb", "16", "mesh serving"),
    ("--flywheel-every", "5", "flywheel"),
    ("--compilation-cache", "off", "compilation cache"),
])
def test_later_flags_refused_by_name(flag, value, slice_, capsys):
    """Each JAX serving flag whose feature a later slice brings is refused
    with its name and what brings it, never accepted and ignored."""
    with pytest.raises(SystemExit) as ei:
        serve_main(["-m", "lenet5", "--device", "cpu", flag, value])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and slice_ in err


def test_list_models_annotates_restorable_checkpoints(tmp_path, capsys):
    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.trainer import Trainer
    wd = tmp_path / "lenet5"
    tr = Trainer(get_config("lenet5"), device="cpu", workdir=str(wd))
    try:
        tr.init_state()
        tr.ckpt.save(3, tr.state.state_dict(), host_state={})
        tr.ckpt.flush()
    finally:
        tr.close()
    assert serve_main(["--list-models", "--runs-root", str(tmp_path)]) == 0
    lines = {ln.split()[0]: ln for ln in capsys.readouterr().out.splitlines()}
    assert "ckpt=epoch 3" in lines["lenet5"]
    assert "ckpt=-" in lines["lenet5_digits"]
    assert "servable=-" in lines["dcgan"]


# -- training spans ----------------------------------------------------------------

def _trace_spans(path):
    doc = json.load(open(path))
    by_name = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X":
            by_name.setdefault(e["name"], []).append(e)
    return by_name


def test_trainer_trace_out_window_spans_equal_jax(tmp_path):
    """lenet5, 8 steps at log_every 2, through both trainers with tracing
    armed: the same spans (4 windows, each with its data-wait and
    dispatch splits, one checkpoint commit) carrying the same arguments;
    the splits fit inside their window; the trace is written once."""
    import dataclasses

    from deepvision_tpu.configs import get_config as jax_get_config
    from deepvision_tpu.core.trainer import Trainer as JaxTrainer
    from deepvision_tpu.data.synthetic import (
        SyntheticClassification as JaxSynthetic)
    from deepvision_tpu_torch.configs import get_config
    from deepvision_tpu_torch.core.trainer import Trainer
    from deepvision_tpu_torch.data.synthetic import SyntheticClassification

    spans = {}
    for side, get, trainer_cls, synth in (
            ("jax", jax_get_config, JaxTrainer, JaxSynthetic),
            ("port", get_config, Trainer, SyntheticClassification)):
        cfg = get("lenet5").replace(batch_size=8, total_epochs=1,
                                    log_every_steps=2)
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, image_size=32, train_examples=64, val_examples=16))
        out = str(tmp_path / f"{side}.json")
        kw = {} if side == "jax" else {"device": "cpu"}
        trainer = trainer_cls(cfg, workdir=str(tmp_path / side), **kw)
        trainer.arm_tracing(out)

        def batches(steps, seed, synth=synth, cfg=cfg):
            return synth(cfg.batch_size, 32, 1, cfg.data.num_classes,
                         steps, seed=seed)

        if side == "jax":
            trainer.init_state((32, 32, 1))
            trainer.fit(lambda e: batches(8, e),
                        lambda e: batches(2, 10 ** 6),
                        sample_shape=(32, 32, 1))
        else:
            trainer.init_state()
            trainer.fit(lambda e: batches(8, e),
                        lambda e: batches(2, 10 ** 6))
        trainer.close()
        trainer.close()          # idempotent: written exactly once
        spans[side] = _trace_spans(out)
    got, want = spans["port"], spans["jax"]
    assert {k: len(v) for k, v in got.items()} == \
        {k: len(v) for k, v in want.items()} == {
            "train_window": 4, "host_data_wait": 4, "train_dispatch": 4,
            "ckpt_commit": 1}
    for name in got:
        jax_keys = set(want[name][0]["args"]) - {"dispatches_total"}
        assert set(got[name][0]["args"]) == jax_keys, name
    win = got["train_window"][0]
    assert win["args"]["steps"] == 2
    wid = win["args"]["span_id"]
    wait = next(e for e in got["host_data_wait"]
                if e["args"]["window"] == wid)
    disp = next(e for e in got["train_dispatch"]
                if e["args"]["window"] == wid)
    assert wait["dur"] + disp["dur"] <= win["dur"] * 1.05
    assert disp["dur"] > 0


def test_train_cli_carries_trace_out():
    from deepvision_tpu_torch.cli import build_parser
    args = build_parser("LeNet", ["lenet5"]).parse_args(
        ["-m", "lenet5", "--trace-out", "/tmp/t.json"])
    assert args.trace_out == "/tmp/t.json"
