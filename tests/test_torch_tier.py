"""The port's replica tier (deepvision_tpu_torch/serve/{tier,replica}.py)
and its replica faults held to the JAX package's own code.

The tier is stdlib code, so parity is behavioural: the JAX `TierRouter`
(deepvision_tpu/serve/tier.py, loaded from its file through the stand-in
package of tests/test_torch_serve_ops.py::jax_serve_modules) and the
port's drive the same scenarios against this file's stdlib fake replica
(the pattern of tests/test_tier.py, which cannot be imported here: it
imports the JAX serve package), one after the other. Each scenario
returns its decisions (where the requests went, the statuses, the roll's
outcomes, what the merged /metrics holds) and the names of the events the
router wrote; both must be equal. The event names are compared as sets:
the router's threads write them, and how often a breaker reopens while a
replica boots depends on timing.

The autoscaler's `scale_out` hook is called as JAX's is on a scripted
load. The fault-env parsing of REPLICA_CRASH, REPLICA_WEDGE and
DRIFT_SHIFT equals JAX's, errors included. One real-replica test drains
a lenet5 server on the CPU under router traffic with zero failures, and
the `--kill-one` smoke runs once through the port's `tier.main` with two
replica subprocesses on the CPU.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deepvision_tpu.obs.export import \
    validate_prometheus_text as jax_validate_prometheus_text
from deepvision_tpu.utils import faults as jax_faults
from deepvision_tpu_torch.obs.export import (parse_prometheus_text,
                                             validate_prometheus_text)
from deepvision_tpu_torch.serve import tier
from deepvision_tpu_torch.serve.engine import PredictEngine
from deepvision_tpu_torch.serve.fleet import ModelFleet
from deepvision_tpu_torch.serve.server import InferenceServer
from deepvision_tpu_torch.utils import faults
from test_torch_serve_ops import jax_serve_modules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_REPLICA = r'''
import json, os, sys, threading, time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PORT = int(sys.argv[1])
RID = os.environ.get("FAKE_REPLICA_ID", "?")
QUEUE = int(os.environ.get("FAKE_QUEUE_DEPTH", "0"))
WORKERS = int(os.environ.get("FAKE_WORKERS", "1"))
CRASH = os.environ.get("FAKE_CRASH_AFTER")
CRASH = int(CRASH) if CRASH else None
WEDGE = os.environ.get("FAKE_WEDGE_AFTER")
WEDGE = int(WEDGE) if WEDGE else None
RELOAD_MODE = os.environ.get("FAKE_RELOAD_MODE", "none")

lock = threading.Lock()
state = {"predicts": 0, "wedged": False, "reload_calls": 0,
         "reloads": 0, "refused_gate": 0, "epoch": 1, "last_rid": None}


def model():
    return {"lenet5": {
        "workers": WORKERS, "queue_depth": QUEUE,
        "reload": {"reloads": state["reloads"],
                   "refused_gate": state["refused_gate"],
                   "rolled_back": 0, "refused_corrupt": 0,
                   "refused_incompatible": 0},
        "weights": {"checkpoint_epoch": state["epoch"]},
        "compile": {"entries": 1, "cache_hits": 1, "cache_misses": 0,
                    "compile_s": 0.0}}}


class H(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _maybe_fault(self, predict):
        with lock:
            if predict and not state["wedged"]:
                n = state["predicts"]
                state["predicts"] += 1
                if CRASH is not None and n >= CRASH:
                    os._exit(86)
                if WEDGE is not None and n >= WEDGE:
                    state["wedged"] = True
            hang = state["wedged"]
        if hang:
            while True:
                time.sleep(3600)

    def _json(self, code, obj):
        b = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(b)))
        rid = self.headers.get("X-Request-Id")
        if rid:
            self.send_header("X-Request-Id", rid)
        self.end_headers()
        self.wfile.write(b)

    def do_GET(self):
        self._maybe_fault(False)
        if self.path == "/healthz":
            return self._json(200, {
                "status": "ok", "replica": RID, "queue_depth": QUEUE,
                "models": model(),
                "weights": {"checkpoint_epoch": state["epoch"]},
                "reload_calls": state["reload_calls"],
                "last_request_id": state["last_rid"]})
        if self.path == "/metrics":
            n = state["predicts"]
            text = (
                "# HELP deepvision_serve_requests_total t\n"
                "# TYPE deepvision_serve_requests_total counter\n"
                'deepvision_serve_requests_total{model="lenet5"} %d\n'
                "# HELP deepvision_serve_request_latency_seconds t\n"
                "# TYPE deepvision_serve_request_latency_seconds "
                "histogram\n"
                'deepvision_serve_request_latency_seconds_bucket'
                '{le="0.1"} 1\n'
                'deepvision_serve_request_latency_seconds_bucket'
                '{le="+Inf"} 2\n'
                "deepvision_serve_request_latency_seconds_sum 0.3\n"
                "deepvision_serve_request_latency_seconds_count 2\n" % n)
            b = text.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(b)))
            self.end_headers()
            self.wfile.write(b)
            return
        return self._json(404, {"error": "unknown path"})

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self.rfile.read(n)
        if self.path == "/reload":
            with lock:
                state["reload_calls"] += 1
                if RELOAD_MODE == "promote":
                    state["reloads"] += 1
                    state["epoch"] += 1
                    swapped = 1
                elif RELOAD_MODE == "refuse_gate":
                    state["refused_gate"] += 1
                    swapped = 0
                else:
                    swapped = 0
            return self._json(200, {"swapped": swapped, "models": model()})
        self._maybe_fault(self.path.startswith("/predict"))
        if self.path == "/predict" or self.path.startswith("/predict/"):
            name = (self.path[len("/predict/"):]
                    if self.path.startswith("/predict/") else "")
            if name and name != "lenet5":
                return self._json(404, {
                    "error": "unknown model %r" % name,
                    "served_models": ["lenet5"]})
            with lock:
                state["last_rid"] = self.headers.get("X-Request-Id")
            return self._json(200, {"predictions": [[0.0]],
                                    "generation": "live",
                                    "weights_epoch": state["epoch"],
                                    "replica": RID})
        return self._json(404, {"error": "unknown path"})


srv = ThreadingHTTPServer(("127.0.0.1", PORT), H)
srv.daemon_threads = True
srv.serve_forever()
'''


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def routers():
    """name -> the tier module of each side: the JAX one from its file
    under the stand-in package, the port's."""
    with jax_serve_modules("tier", "autoscale") as mods:
        yield {"jax": mods.tier, "port": tier,
               "jax_autoscale": mods.autoscale}


class _Events:
    """A logger that keeps the names of the resilience events."""

    def __init__(self):
        self.names = set()
        self._lock = threading.Lock()

    def log(self, step, metrics, **kw):
        with self._lock:
            self.names.update(k for k in metrics if k.startswith("tier_"))

    def close(self):
        pass


def _script(tmp_path):
    p = tmp_path / "fake_replica.py"
    if not p.exists():
        p.write_text(FAKE_REPLICA)
    return str(p)


def _wait_port(port, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        s = socket.socket()
        s.settimeout(0.2)
        try:
            if s.connect_ex(("127.0.0.1", port)) == 0:
                return True
        finally:
            s.close()
        time.sleep(0.02)
    return False


def _start_fake(tmp_path, rid, env=None):
    port = tier.free_port()
    e = dict(os.environ, FAKE_REPLICA_ID=str(rid), **(env or {}))
    proc = subprocess.Popen([sys.executable, _script(tmp_path), str(port)],
                            env=e)
    assert _wait_port(port), f"fake replica {rid} never bound :{port}"
    return proc, port


def _post(base, path="/predict", body=b'{"instances": [[[0.5]]]}',
          headers=None, timeout=30):
    req = urllib.request.Request(
        base + path, data=body,
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=timeout)


def _get_json(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


class _Tier:
    """One scenario's fakes and router on one side (`mod` is that side's
    tier module); closes both."""

    def __init__(self, mod, tmp_path, specs, router_kw=None):
        self.mod, self.procs, handles = mod, [], []
        for i, spec in enumerate(specs):
            spec = dict(spec)
            handle_kw = spec.pop("handle", {})
            if spec.pop("supervised", False):
                port = tier.free_port()
                env = dict(os.environ, FAKE_REPLICA_ID=str(i), **spec)
                handles.append(mod.ReplicaHandle(
                    str(i), f"http://127.0.0.1:{port}",
                    argv=[sys.executable, _script(tmp_path), str(port)],
                    env=env, slot=i, **handle_kw))
            else:
                proc, port = _start_fake(tmp_path, i, spec)
                self.procs.append(proc)
                handles.append(mod.ReplicaHandle(
                    str(i), f"http://127.0.0.1:{port}", slot=i,
                    **handle_kw))
        self.events = _Events()
        kw = {"health_every_s": 0.1, "probe_timeout_s": 0.4,
              "restart_backoff_s": 0.2, **(router_kw or {})}
        self.router = mod.TierRouter(handles, port=0, logger=self.events,
                                     **kw)
        self.router.start()
        self.base = f"http://127.0.0.1:{self.router.bound_port}"
        assert self.router.wait_ready(n=len(specs), timeout=30)

    def close(self):
        self.router.close()
        for p in self.procs:
            p.kill()
            p.wait()


def _least_loaded(t):
    for _ in range(12):
        with _post(t.base) as r:
            assert r.status == 200
    return {"routed": [h.routed for h in t.router.replicas]}


def _request_id(t):
    with _post(t.base, headers={"X-Request-Id": "tier-demo-1"}) as r:
        echoed = (r.status, r.headers.get("X-Request-Id"),
                  r.headers.get("X-Tier-Replica"))
    seen = _get_json(t.router.replicas[0].url + "/healthz")[
        "last_request_id"]
    with _post(t.base) as r:
        minted = bool(r.headers.get("X-Request-Id"))
    return {"echoed": echoed, "seen": seen, "minted": minted}


def _not_found(t):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(t.base, path="/predict/nope")
    body = json.loads(ei.value.read().decode())
    return {"status": ei.value.code, "served": body["served_models"],
            "retries": t.router.stats["retries"]}


def _crash(t):
    h0 = t.router.replicas[0]
    failures = 0
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            with _post(t.base) as r:
                assert r.status == 200
        except Exception:  # noqa: BLE001 — counted, compared
            failures += 1
        if h0.launches >= 2 and t.router.stats["readmissions"] >= 3:
            break
        time.sleep(0.02)
    assert t.router.wait_ready(n=2, timeout=30)
    s = t.router.stats
    return {"failures": failures, "exit_code": h0.last_exit_code,
            "relaunched": h0.launches >= 2, "ejected": s["ejections"] >= 1,
            "restarted": s["restarts"] >= 1, "routable": h0.routable}


def _wedge(t):
    hw, hg = t.router.replicas
    for _ in range(8):
        with _post(t.base, headers={"X-Deadline-Ms": "1500"}) as r:
            assert r.status == 200
        if hw.routed == 0 and hw.failures >= 1:
            break
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and hw.routable:
        time.sleep(0.05)
    return {"wedged_routable": hw.routable, "wedged_routed": hw.routed,
            "good_answered": hg.routed >= 1,
            "ejected": t.router.stats["ejections"] >= 1}


def _roll(t):
    rec = t.router.roll.roll_once()
    calls = [_get_json(h.url + "/healthz")["reload_calls"]
             for h in t.router.replicas]
    return {"state": rec["state"], "promoted": rec["promoted"],
            "outcomes": [(o["outcome"], o.get("refusals"))
                         for o in rec["outcomes"]],
            "reload_calls": calls,
            "front_door": _get_json(t.base + "/healthz")["roll"]["state"]}


def _metrics(t):
    for _ in range(4):
        with _post(t.base) as r:
            assert r.status == 200
    text = urllib.request.urlopen(t.base + "/metrics",
                                  timeout=10).read().decode()
    assert validate_prometheus_text(text) == []
    assert jax_validate_prometheus_text(text) == []
    parsed = parse_prometheus_text(text)
    return {"keys": sorted(k for k in parsed
                           if not k[0].startswith("deepvision_tier_inflight")),
            "latency_count": parsed[
                ("deepvision_serve_request_latency_seconds_count", ())],
            "routed": sum(v for k, v in parsed.items()
                          if k[0] == "deepvision_tier_routed_total")}


SCENARIOS = {
    # replica 0 advertises 50 queued on 1 worker: every request goes to 1
    "least_loaded": ([{"FAKE_QUEUE_DEPTH": "50"}, {}], {}, _least_loaded),
    "request_id": ([{}], {}, _request_id),
    "unknown_model_404": ([{}], {}, _not_found),
    # os._exit(86) on the third predict: ejected, respawned, readmitted
    "crash": ([{"supervised": True, "FAKE_CRASH_AFTER": "2"},
               {"supervised": True}], {}, _crash),
    # accepts, never answers: the bounded probe opens the slot's breaker
    "wedge": ([{"FAKE_WEDGE_AFTER": "0",
                "handle": {"breaker_k": 2, "breaker_cooldown_s": 0.5}}, {}],
              {"attempt_timeout_s": 0.5}, _wedge),
    "clean_roll": ([{"FAKE_RELOAD_MODE": "promote"}] * 3,
                   {"roll_model": "lenet5"}, _roll),
    "regressing_roll": ([{"FAKE_RELOAD_MODE": "promote"},
                         {"FAKE_RELOAD_MODE": "refuse_gate"},
                         {"FAKE_RELOAD_MODE": "promote"}],
                        {"roll_model": "lenet5"}, _roll),
    "merged_metrics": ([{}, {}], {}, _metrics),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_router_decisions_and_events_equal_jax(routers, tmp_path, scenario):
    specs, router_kw, run = SCENARIOS[scenario]
    got = {}
    for side in ("jax", "port"):
        mod = routers[side]
        t = _Tier(mod, tmp_path, specs, router_kw)
        try:
            decisions = run(t)
        finally:
            t.close()
        got[side] = (decisions, sorted(t.events.names))
    assert got["port"] == got["jax"]
    decisions, events = got["port"]
    # each scenario's contract, beside the equality
    if scenario == "least_loaded":
        assert decisions["routed"] == [0, 12]
    elif scenario == "crash":
        assert decisions["failures"] == 0 and decisions["exit_code"] == 86
        assert {"tier_replica_exit", "tier_replica_ejected",
                "tier_replica_restarted",
                "tier_replica_readmitted"} <= set(events)
    elif scenario == "wedge":
        assert not decisions["wedged_routable"]
        assert decisions["wedged_routed"] == 0
    elif scenario == "clean_roll":
        assert decisions["outcomes"] == [("promoted", None)] * 3
        assert "tier_roll_completed" in events
    elif scenario == "regressing_roll":
        assert decisions["outcomes"] == [("promoted", None), (
            "rolled_back", {"refused_gate": 1.0})]
        assert decisions["reload_calls"] == [1, 1, 0]
        assert "tier_roll_rolled_back" in events
    elif scenario == "merged_metrics":
        assert decisions["latency_count"] == 4.0
        assert decisions["routed"] == 4.0
        assert ("deepvision_serve_requests_total",
                (("model", "lenet5"), ("replica", "1"))) in decisions["keys"]


@pytest.mark.parametrize("broken", [False, True])
def test_autoscaler_scale_out_hook_equals_jax(routers, monkeypatch, broken):
    """The autoscaler's escalation calls the `scale_out` hook (the tier's
    add-a-replica lever) with the same arguments at the same samples as
    JAX's; a hook that raises changes no decision."""
    from deepvision_tpu_torch.serve import autoscale
    from test_torch_serve_ops import AUTOSCALE_SCRIPT, _Clock, _ScriptedModel

    def run(module):
        clock = _Clock()
        monkeypatch.setattr(module.time, "monotonic", clock)
        calls = []

        def hook(sm, *, refused, queue_depth):
            calls.append((len(decisions), sm.name, refused, queue_depth))
            if broken:
                raise RuntimeError("no replica to add")

        sm = _ScriptedModel()
        ctl = module.AutoscaleController(
            [sm], interval_s=0, min_workers=1, max_workers=3, up_after=2,
            down_after=3, cooldown_s=1.0, scale_out=hook)
        decisions = []
        for _, shed, queue, p99 in AUTOSCALE_SCRIPT:
            clock.t += 0.6
            sm._totals["shed"] += shed
            sm.queue, sm.p99 = queue, p99
            decisions.append((ctl.check_once(), sm.pool))
        return calls, decisions

    got = run(autoscale)
    assert got == run(routers["jax_autoscale"])
    assert got[0] and got[0][0][1:] == ("m", 3, 0)


# -- the replica faults --------------------------------------------------------

FAULT_ENVS = [
    {"DEEPVISION_FAULT_REPLICA_CRASH": "7",
     "DEEPVISION_FAULT_REPLICA_WEDGE": "9"},
    {"DEEPVISION_FAULT_REPLICA_CRASH": "x"},
    {"DEEPVISION_FAULT_DRIFT_SHIFT": "3:2.5"},
    {"DEEPVISION_FAULT_DRIFT_SHIFT": "0:-1e-3"},
] + [{"DEEPVISION_FAULT_DRIFT_SHIFT": bad}
     for bad in ("x:1.0", "3", "3:", "3:abc", "3:0.0")]


def _parse(cls, env):
    try:
        inj = cls.from_env(env)
    except Exception as e:  # noqa: BLE001 — the error is the result
        return type(e).__name__, str(e)
    return ({f: getattr(inj, f) for f in (
                "replica_crash_after", "replica_wedge_after",
                "drift_shift_window", "drift_shift_magnitude", "active")},
            [inj.drift_shift(w) for w in range(5)])


@pytest.mark.parametrize("env", FAULT_ENVS, ids=lambda e: ",".join(
    f"{k.split('_FAULT_')[1]}={v}" for k, v in e.items()))
def test_replica_and_drift_fault_env_equals_jax(env):
    """The same environment through both injectors: the same fields and
    drift shifts, or the same error, word for word."""
    assert _parse(faults.FaultInjector, env) == \
        _parse(jax_faults.FaultInjector, env)


FAULTS_PATH = os.path.join(REPO, "deepvision_tpu_torch", "utils",
                           "faults.py")


@pytest.mark.parametrize("calls,code", [
    ("fi.on_replica_request(); fi.on_replica_request()\n"
     "fi.on_replica_request()\n", 86),                 # the third: exit
    ("for _ in range(10):\n    fi.on_replica_request(predict=False)\n"
     "fi.on_replica_request()\n", 0),                  # polls never count
])
def test_replica_crash_exits_after_k_predicts(calls, code):
    script = ("import importlib.util\n"
              f"spec = importlib.util.spec_from_file_location('faults', "
              f"{FAULTS_PATH!r})\n"
              "faults = importlib.util.module_from_spec(spec)\n"
              "spec.loader.exec_module(faults)\n"
              "fi = faults.FaultInjector(replica_crash_after="
              f"{2 if code else 1})\n" + calls + "raise SystemExit(0)\n")
    assert subprocess.run([sys.executable, "-c", script],
                          timeout=60).returncode == code


# -- real replicas -------------------------------------------------------------

def test_drain_under_router_traffic_costs_zero_failures():
    """SIGTERM-equivalent on replica a of two real lenet5 servers: /healthz
    flips to "draining" before the batcher drain, and the 0.6 s grace
    outlives the router's 0.1 s poll, so a is de-admitted while it still
    answers everything (JAX's tests/test_tier.py drain pin)."""
    def serve_one(rid):
        fleet = ModelFleet()
        fleet.add(PredictEngine.from_config("lenet5", device="cpu",
                                            buckets=(1, 4), verbose=False),
                  max_delay_ms=2.0)
        srv = InferenceServer(fleet=fleet, flush_every_s=60.0,
                              drain_grace_s=0.6, replica_id=rid)
        th = threading.Thread(target=srv.serve, kwargs={"port": 0},
                              daemon=True)
        th.start()
        assert srv.ready.wait(120)
        return srv, th

    sa, ta = serve_one("a")
    sb, tb = serve_one("b")
    router = tier.TierRouter(
        [tier.ReplicaHandle("a", f"http://127.0.0.1:{sa.bound_port}",
                            slot=0),
         tier.ReplicaHandle("b", f"http://127.0.0.1:{sb.bound_port}",
                            slot=1)],
        port=0, health_every_s=0.1, probe_timeout_s=0.4)
    router.start()
    try:
        assert router.wait_ready(n=2, timeout=30)
        assert _get_json(f"http://127.0.0.1:{sa.bound_port}/healthz")[
            "replica"] == "a"
        base = f"http://127.0.0.1:{router.bound_port}"
        x = np.random.RandomState(0).randn(1, 32, 32, 1).tolist()
        payload = json.dumps({"instances": x}).encode()
        stop = threading.Event()
        failures = []

        def client():
            while not stop.is_set():
                try:
                    with _post(base, body=payload) as r:
                        assert r.status == 200
                except Exception as e:  # noqa: BLE001 — the assertion
                    failures.append(repr(e))

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.6)
        sa.stop()
        time.sleep(1.5)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert failures == [], failures[:3]
        a, b = router.replicas
        assert not a.routable and b.routed > 0
        assert router.stats["ejections"] >= 1
    finally:
        router.close()
        sb.stop()
        ta.join(timeout=60)
        tb.join(timeout=60)


def test_tier_smoke_kill_one_through_main(capsys, monkeypatch):
    """`python -m deepvision_tpu_torch.serve.tier -m lenet5 --replicas 2
    --smoke --kill-one --device cpu`: one replica SIGKILLed mid-load, zero
    failed responses, the replica respawned and readmitted."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = tier.main(["-m", "lenet5", "--replicas", "2", "--smoke",
                    "--kill-one", "--duration", "4", "--device", "cpu",
                    "--port", "0", "--smoke-threads", "2"])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, verdict
    assert verdict["tier_smoke"] == "pass"
    assert verdict["failed_responses"] == 0 and verdict["restarts"] >= 1


@pytest.mark.parametrize("argv,match", [
    (["--cache-dir", "/tmp/x"], "--cache-dir is not ported"),
    (["--kill-one"], "--kill-one is a --smoke option"),
    (["--replicas", "0"], "--replicas must be >= 1"),
])
def test_tier_flags_refused(capsys, argv, match):
    with pytest.raises(SystemExit):
        tier.main(["-m", "lenet5", *argv])
    assert match in capsys.readouterr().err


def test_compile_record_counts_cache_hits_and_builds(monkeypatch):
    """A replica's /healthz `compile` record: each kernel library this
    process loaded, from the build cache (a hit) or built by nvcc here (a
    miss, its nvcc seconds in `compile_s`); nothing loaded on the CPU."""
    from deepvision_tpu_torch.ops import _build
    assert _build.compile_record() == {
        "entries": 0, "cache_hits": 0, "cache_misses": 0, "compile_s": 0,
        "libraries": {}}
    monkeypatch.setattr(_build, "LOADED",
                        {"flash_attention": "hit", "best_iou": "miss"})
    monkeypatch.setattr(_build, "BUILD_INFO",
                        {"best_iou": {"seconds": 7.4, "ptxas": ""}})
    assert _build.compile_record() == {
        "entries": 2, "cache_hits": 1, "cache_misses": 1, "compile_s": 7.4,
        "libraries": {"flash_attention": "hit", "best_iou": "miss"}}


def test_replica_gate_needs_no_reload_poller():
    """A replica arms the gate without --reload-every (the router drives
    POST /reload); the standalone CLI still couples them."""
    from deepvision_tpu_torch.serve import cli, replica
    p = replica.build_replica_parser()
    args = p.parse_args(["-m", "lenet5", "--promote-gate", "-0.02",
                         "--replica-id", "3"])
    cli.validate_args(p, args, require_reload_for_gate=False)
    assert args.drain_grace == 0.75 and args.replica_id == "3"
    with pytest.raises(SystemExit):
        cli.main(["-m", "lenet5", "--promote-gate", "-0.02"])
