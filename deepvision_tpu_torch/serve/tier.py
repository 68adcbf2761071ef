"""Replica tier: one router process, N supervised replica processes (port
of deepvision_tpu/serve/tier.py).

Every serving PR so far hardens ONE process — batcher backpressure,
circuit breaker, admission control, graceful drain. One process is still
one blast radius: a segfault, a wedged dispatcher, or a bad promotion
takes the whole front door with it. The tier splits the front door from
the model processes:

    client -> TierRouter (this module, stdlib HTTP) -> replica 0..N-1
              least-loaded routing                     (serve/replica.py,
              per-replica circuit breaking              each the full
              supervised restart + backoff              fleet server)
              rolling promotion
              merged /metrics

The router never touches the card and never parses a request body: it
forwards the bytes verbatim. Contracts it keeps (rehearsable through
utils/faults.py, held to the JAX router by tests/test_torch_tier.py):

- **Least-loaded routing**: each request goes to the admitted replica
  with the lowest `inflight + queue_depth/workers` score (inflight is the
  router's own immediate signal; queue depth/workers come from the
  replica's `/healthz`, polled every `health_every_s`). Ties rotate.
- **Ejection on the spot**: a connection-refused (crashed replica) ejects
  the slot immediately — no K-failure wait, a dead socket is not a
  statistic. Wedges (accepts, never answers) are caught by the
  deadline-bounded health probe: `probe_timeout_s` bounds every probe, K
  consecutive failures open the slot's `CircuitBreaker`
  (serve/autoscale.py — same pattern, tier-level) and the slot stops
  taking traffic; half-open probes re-admit it when it answers again.
- **Supervised restart**: slots launched by the router (argv-bearing) are
  respawned after exit with exponential backoff
  (`restart_backoff_s`..`restart_backoff_max_s`, reset on readmission).
  Every transition is a `resilience_tier_*` event on the tier's JSONL
  stream: `tier_replica_exit`, `tier_replica_restarted`,
  `tier_replica_ejected`, `tier_replica_readmitted`, `tier_roll_*`.
- **Zero failed responses across a replica loss**: a transport failure or
  5xx on one replica retries the SAME request on the next admitted
  replica (the request was never dispatched — the batcher refuses before
  queueing on 503/429, and a crashed socket never dispatched). 400/404
  (and a clean 200) are authoritative and pass through verbatim —
  including the 404 served-models body.
- **Rolling promotion**: `POST /roll` (or `roll_every_s`) drives the
  promotion gate one replica at a time through each replica's synchronous
  `POST /reload`: promote -> advance to the next replica; any refusal
  (gate, canary rollback, corrupt, incompatible) STOPS the roll — a
  regressing candidate is exposed on exactly one replica. Responses
  carry `generation` + `weights_epoch` pinned at submit time by the
  replica (serve/fleet.py `submit_routed`), so mixed-generation audits
  are per-response facts.
- **Warm boot**: the port compiles nothing per bucket; what a replica
  builds at first use are the CUDA kernel libraries (ops/_build.py), whose
  cache in the checkout every replica on a machine shares, so only the
  first build on a machine runs nvcc. `/healthz` carries each replica's
  record of the libraries it loaded (hits from the cache, misses built by
  nvcc), so "restart = warm" is checkable. The JAX tier's `--cache-dir`
  (one persistent XLA compilation cache for every replica) has no
  counterpart in eager PyTorch and is refused by name.
- **Merged /metrics**: one exposition for the whole tier — counters and
  gauges per replica (`replica` label), fixed-bucket histograms summed
  (obs/export.py `merge_expositions`), plus the router's own
  `deepvision_tier_*` families. Valid under `validate_prometheus_text`.

Router endpoints:

    POST /predict[/<model>]  forward with retry; adds X-Tier-Replica
    GET  /healthz            tier status + per-replica records + roll state
    GET  /metrics            merged exposition (replica label + tier families)
    GET  /stats              router counters (routed, retries, ejections...)
    GET  /trace              router-side spans (chrome://tracing JSON)
    POST /roll               run one rolling promotion sweep now

`python -m deepvision_tpu_torch.serve.tier -m vit_small --replicas 2`
boots the tier on the card (`--device cpu` for the CPU); `--smoke` runs
synthetic HTTP load through the router (with `--kill-one`, SIGKILLs a
replica mid-load and requires zero failed responses plus a supervised
readmission) and prints one JSON verdict:

    python -m deepvision_tpu_torch.serve.tier -m lenet5 --replicas 2 \
        --smoke --kill-one --duration 4 --device cpu
    python -m deepvision_tpu_torch.serve.tier -m vit_small --replicas 2 \
        --runs-root runs --promote-gate -0.02
    curl -X POST localhost:8701/roll     # one rolling promotion sweep
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

from ..core.metrics import MetricsLogger
from ..core.resilience import GracefulShutdown, log_resilience_event
from ..obs.export import _emit, chrome_trace, merge_expositions
from ..obs.trace import Tracer, new_request_id
from .autoscale import CLOSED, CircuitBreaker

_RELOAD_KEYS = ("reloads", "refused_gate", "rolled_back", "refused_corrupt",
                "refused_incompatible")


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (bind 0, read, close). The replica
    HTTPServer sets allow_reuse_address, so a respawned replica rebinds
    the same slot port even straight after a crash."""
    s = socket.socket()
    try:
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _http_json(url: str, *, timeout: float, method: str = "GET",
               body: Optional[bytes] = None,
               headers: Optional[dict] = None):
    """(status, parsed-json) for small control-plane calls. Raises on
    transport failure; HTTP errors return their status + body."""
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode() or "{}")
        except Exception:  # noqa: BLE001 — body shape is the replica's call
            return e.code, {}


class ReplicaHandle:
    """One tier slot: the replica URL, the (optional) argv the supervisor
    respawns it with, its circuit breaker, and the router-side load/health
    signals routing reads. Mutable fields are guarded by `lock` (health
    poller, supervisor, and request threads all touch them)."""

    def __init__(self, rid: str, url: str, *,
                 argv: Optional[Sequence[str]] = None,
                 env: Optional[dict] = None,
                 slot: int = 0,
                 breaker_k: int = 3,
                 breaker_cooldown_s: float = 1.0):
        self.rid = str(rid)
        self.slot = int(slot)
        self.url = url.rstrip("/")
        self.argv = list(argv) if argv else None
        self.env = dict(env) if env else None
        self.breaker_k = int(breaker_k)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.breaker = self._fresh_breaker()
        self.lock = threading.Lock()
        self.proc: Optional[subprocess.Popen] = None
        # a supervised slot is dead until its process boots AND answers
        # /healthz; an attach-only slot (tests) is unknown until probed
        self.dead = self.argv is not None
        self.healthy = False
        self.draining = False
        self.queue_depth = 0
        self.workers = 1
        self.inflight = 0
        self.routed = 0          # requests answered through this slot
        self.failures = 0        # transport/5xx outcomes charged to it
        self.launches = 0
        self.exits = 0
        self.last_exit_code: Optional[int] = None
        self.last_health: Optional[dict] = None
        self.last_health_unix = 0.0
        # supervisor state: launch immediately on start, back off on exit
        self.pending_restart = self.argv is not None
        self.next_restart_at = 0.0
        self.backoff_s = 0.5
        self.routable_prev = False

    def _fresh_breaker(self) -> CircuitBreaker:
        # recreated on every respawn: a new process owes nothing to the
        # failure streak that killed its predecessor
        return CircuitBreaker(f"tier-replica-{self.rid}",
                              k=self.breaker_k,
                              cooldown_s=self.breaker_cooldown_s)

    @property
    def routable(self) -> bool:
        return (not self.dead and self.healthy and not self.draining
                and self.breaker.state == CLOSED)

    def score(self) -> float:
        """Least-loaded routing score: the router's own in-flight count
        plus the replica's queue depth normalised by its dispatcher pool
        (8 queued on 4 workers loads like 2 queued on 1)."""
        with self.lock:
            return self.inflight + self.queue_depth / max(1, self.workers)

    def describe(self) -> dict:
        with self.lock:
            lh = self.last_health or {}
            models = lh.get("models") or {}
            d = {
                "replica": self.rid, "slot": self.slot, "url": self.url,
                "routable": self.routable, "healthy": self.healthy,
                "draining": self.draining, "dead": self.dead,
                "supervised": self.argv is not None,
                "inflight": self.inflight, "queue_depth": self.queue_depth,
                "workers": self.workers, "routed": self.routed,
                "failures": self.failures, "launches": self.launches,
                "restarts": max(0, self.launches - 1), "exits": self.exits,
                "last_exit_code": self.last_exit_code,
                "breaker": self.breaker.describe(),
                "weights_epoch": (lh.get("weights") or {}).get(
                    "checkpoint_epoch"),
                # warm-boot audit: cache_misses == 0 on every boot after
                # the first means the shared kernel build cache did its job
                "compile": {name: (m.get("compile") or {})
                            for name, m in models.items()},
                # the replica autoscaler's escalation: its workers are
                # exhausted and the model still sheds — the tier (this
                # layer) owns the next lever, a new replica
                "wants_scale_out": any(
                    (m.get("autoscale") or {}).get("wants_scale_out")
                    for m in models.values()),
            }
        return d


class RollingPromotion:
    """Drives the promotion gate across the tier one replica at a
    time. Each step is the replica's own synchronous `POST /reload`
    (serve/reload.py `check_once` — shadow eval, gate, optional canary all
    resolve before the response returns), so the router knows the verdict
    the moment the call completes:

        promoted      -> advance to the next replica
        any refusal   -> STOP: the candidate was exposed on exactly one
                         replica; the rest keep their generation
        no candidate  -> advance (nothing to do on that replica)
        unreachable   -> abort the sweep (supervisor will deal with it)
    """

    def __init__(self, router: "TierRouter", *, model: Optional[str] = None,
                 timeout_s: float = 600.0, ready_timeout_s: float = 30.0):
        self.router = router
        self.model = model
        self.timeout_s = float(timeout_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self._busy = threading.Lock()
        self._state_lock = threading.Lock()
        self.rolls = 0
        self.current: dict = {"state": "idle", "outcomes": []}
        self.history: List[dict] = []

    def describe(self) -> dict:
        with self._state_lock:
            return {"rolls": self.rolls, **self.current}

    def roll_once(self) -> dict:
        if not self._busy.acquire(blocking=False):
            return {"state": "busy",
                    "error": "a rolling promotion is already in progress"}
        try:
            return self._roll()
        finally:
            self._busy.release()

    def _wait_routable(self, h: ReplicaHandle) -> bool:
        deadline = time.monotonic() + self.ready_timeout_s
        while time.monotonic() < deadline:
            if h.routable:
                return True
            if self.router.stopped.wait(0.1):
                return False
        return h.routable

    def _reload_stats(self, h: ReplicaHandle) -> Dict[str, float]:
        _, js = _http_json(h.url + "/healthz",
                           timeout=self.router.probe_timeout_s)
        models = js.get("models") or {}
        mkey = self.model or (next(iter(models)) if models else None)
        rl = (models.get(mkey) or {}).get("reload") or {}
        return {k: float(rl.get(k, 0)) for k in _RELOAD_KEYS}

    def _roll(self) -> dict:
        router = self.router
        self._set({"state": "rolling", "outcomes": []})
        router._event({"tier_roll_started": 1.0})
        outcomes: List[dict] = []
        state, promoted = "idle", 0
        for h in router.replicas:
            if not self._wait_routable(h):
                outcomes.append({"replica": h.rid,
                                 "outcome": "skipped_unready"})
                self._set({"state": "rolling", "outcomes": list(outcomes)})
                continue
            try:
                before = self._reload_stats(h)
                code, js = _http_json(
                    h.url + "/reload", method="POST", body=b"{}",
                    headers={"Content-Type": "application/json"},
                    timeout=self.timeout_s)
            except Exception as e:  # noqa: BLE001 — sweep must report
                outcomes.append({"replica": h.rid, "outcome": "unreachable",
                                 "error": repr(e)})
                state = "aborted"
                router._event({"tier_roll_aborted": 1.0,
                               "replica_slot": float(h.slot)})
                break
            if code != 200:
                outcomes.append({"replica": h.rid, "outcome": "error",
                                 "status": code, "body": js})
                state = "aborted"
                router._event({"tier_roll_aborted": 1.0,
                               "replica_slot": float(h.slot)})
                break
            models = js.get("models") or {}
            mkey = self.model or (next(iter(models)) if models else None)
            rl = (models.get(mkey) or {}).get("reload") or {}
            delta = {k: float(rl.get(k, 0)) - before.get(k, 0.0)
                     for k in _RELOAD_KEYS}
            if int(js.get("swapped") or 0) > 0 or delta["reloads"] > 0:
                epoch = ((models.get(mkey) or {}).get("weights")
                         or {}).get("checkpoint_epoch")
                promoted += 1
                outcomes.append({"replica": h.rid, "outcome": "promoted",
                                 "epoch": epoch})
                router._event({"tier_roll_replica_promoted": 1.0,
                               "replica_slot": float(h.slot),
                               "epoch": float(epoch if epoch is not None
                                              else -1)})
                self._set({"state": "rolling", "outcomes": list(outcomes)})
                continue
            refusals = {k: v for k, v in delta.items()
                        if k != "reloads" and v > 0}
            if refusals:
                outcomes.append({"replica": h.rid, "outcome": "rolled_back",
                                 "refusals": refusals})
                state = "rolled_back"
                router._event({"tier_roll_rolled_back": 1.0,
                               "replica_slot": float(h.slot)})
                print(f"[tier] rolling promotion STOPPED at replica "
                      f"{h.rid}: candidate refused ({refusals}) — "
                      f"remaining replicas keep the live generation",
                      file=sys.stderr, flush=True)
                break
            outcomes.append({"replica": h.rid, "outcome": "no_candidate"})
        if state == "idle" and promoted:
            state = "promoted"
            router._event({"tier_roll_completed": 1.0,
                           "replicas_promoted": float(promoted)})
        rec = {"state": state, "outcomes": outcomes, "promoted": promoted}
        with self._state_lock:
            self.rolls += 1
            self.current = rec
            self.history.append(rec)
            del self.history[:-20]
        return rec

    def _set(self, rec: dict) -> None:
        with self._state_lock:
            self.current = rec


class TierRouter:
    """The tier front door + supervisor. Construct with ReplicaHandles
    (argv-bearing slots are launched and respawned; url-only slots are
    attached as-is — the test seam), `start()`, then direct traffic at
    `http://host:bound_port/predict`."""

    def __init__(self, replicas: Sequence[ReplicaHandle], *,
                 host: str = "127.0.0.1", port: int = 0,
                 health_every_s: float = 0.25,
                 probe_timeout_s: float = 1.0,
                 default_deadline_s: float = 30.0,
                 attempt_timeout_s: Optional[float] = None,
                 restart_backoff_s: float = 0.5,
                 restart_backoff_max_s: float = 8.0,
                 roll_model: Optional[str] = None,
                 roll_every_s: float = 0.0,
                 roll_timeout_s: float = 600.0,
                 log_dir: Optional[str] = None,
                 logger: Optional[MetricsLogger] = None,
                 tracer: Optional[Tracer] = None,
                 device: Optional[str] = None):
        if not replicas:
            raise ValueError("a tier needs at least one replica slot")
        self.replicas = list(replicas)
        self.host = host
        self._port = int(port)
        self.health_every_s = float(health_every_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.default_deadline_s = float(default_deadline_s)
        # per-attempt cap: without it a WEDGED replica (accepts, never
        # answers) burns the whole client deadline on attempt one and the
        # retry never happens. Applied only while OTHER untried replicas
        # remain — the last candidate always gets the full remainder.
        self.attempt_timeout_s = (float(attempt_timeout_s)
                                  if attempt_timeout_s else None)
        self.restart_backoff_s = float(restart_backoff_s)
        self.restart_backoff_max_s = float(restart_backoff_max_s)
        self.roll_every_s = float(roll_every_s)
        for h in self.replicas:
            h.backoff_s = self.restart_backoff_s
        # the log's header names the replicas' device
        self.logger = logger or (MetricsLogger(log_dir, name="tier",
                                               device=device)
                                 if log_dir else None)
        self.tracer = tracer if tracer is not None else Tracer()
        self.roll = RollingPromotion(self, model=roll_model,
                                     timeout_s=roll_timeout_s)
        self.stopped = threading.Event()
        self.ready = threading.Event()
        self.bound_port: Optional[int] = None
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "responses_2xx": 0, "responses_4xx": 0,
                      "responses_5xx": 0, "retries": 0, "no_replica": 0,
                      "ejections": 0, "readmissions": 0, "restarts": 0,
                      "exits": 0}
        self._event_seq = itertools.count(1)
        self._rr = itertools.count()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._threads: List[threading.Thread] = []

    # -- events / accounting -----------------------------------------------

    def _event(self, metrics: dict) -> None:
        log_resilience_event(self.logger, next(self._event_seq), metrics)

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0) + n

    def _note_routable(self, h: ReplicaHandle, cause: str = "") -> None:
        """Single source of ejection/readmission accounting: call after
        any state change; only transitions log/count."""
        now_routable = h.routable
        # transition detection under h.lock: supervisor, prober and router
        # threads all call this, and two observers of one transition must
        # not double-log it (or lose the backoff reset); logging stays
        # outside the lock
        with h.lock:
            if now_routable == h.routable_prev:
                return
            h.routable_prev = now_routable
            if now_routable:
                h.backoff_s = self.restart_backoff_s   # stable again
        if now_routable:
            self._bump("readmissions")
            self._event({"tier_replica_readmitted": 1.0,
                         "replica_slot": float(h.slot)})
            print(f"[tier] replica {h.rid} re-admitted "
                  f"(healthy, breaker {h.breaker.state})",
                  file=sys.stderr, flush=True)
        else:
            self._bump("ejections")
            self._event({"tier_replica_ejected": 1.0,
                         "replica_slot": float(h.slot)})
            print(f"[tier] replica {h.rid} ejected"
                  + (f" ({cause})" if cause else ""),
                  file=sys.stderr, flush=True)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        class _TierServer(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = _TierServer((self.host, self._port), _Handler)
        self._httpd.router = self
        self.bound_port = self._httpd.server_address[1]
        for h in self.replicas:     # boot supervised slots immediately
            if h.argv is not None and h.proc is None:
                self._launch(h)
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever,
                             name="tier-http", daemon=True),
            threading.Thread(target=self._health_loop,
                             name="tier-health", daemon=True),
            threading.Thread(target=self._supervisor_loop,
                             name="tier-supervisor", daemon=True),
        ]
        if self.roll_every_s > 0:
            self._threads.append(threading.Thread(
                target=self._roll_loop, name="tier-roll", daemon=True))
        for t in self._threads:
            t.start()
        self.ready.set()
        print(f"[tier] router on http://{self.host}:{self.bound_port} "
              f"over {len(self.replicas)} replica(s): "
              + ", ".join(h.url for h in self.replicas), flush=True)

    def wait_ready(self, n: int = 1, timeout: float = 180.0) -> bool:
        """Block until at least `n` replicas are routable."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if sum(1 for h in self.replicas if h.routable) >= n:
                return True
            if self.stopped.wait(0.05):
                return False
        return sum(1 for h in self.replicas if h.routable) >= n

    def close(self, *, replica_grace_s: float = 15.0) -> None:
        self.stopped.set()
        for h in self.replicas:
            proc = h.proc
            if proc is not None and proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGTERM)   # graceful drain
                except OSError:
                    pass
        deadline = time.monotonic() + replica_grace_s
        for h in self.replicas:
            proc = h.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5)
        if self.logger is not None:
            self.logger.close()

    # -- supervision ---------------------------------------------------------

    def _launch(self, h: ReplicaHandle) -> None:
        env = dict(os.environ)
        env.update(h.env or {})
        # spawn BEFORE taking h.lock: process creation is slow I/O, and the
        # probe/routing threads must not stall behind it (LCK004 shape)
        proc = subprocess.Popen(h.argv, env=env)
        with h.lock:
            h.proc = proc
            h.pending_restart = False
            h.launches += 1
            launches = h.launches
            if launches > 1:
                h.breaker = h._fresh_breaker()
        if launches > 1:
            self._bump("restarts")
            self._event({"tier_replica_restarted": 1.0,
                         "replica_slot": float(h.slot),
                         "launches": float(launches)})
            print(f"[tier] replica {h.rid} restarted "
                  f"(launch #{launches}, pid {proc.pid}) — awaiting "
                  f"/healthz before re-admission", file=sys.stderr,
                  flush=True)

    def _supervisor_loop(self) -> None:
        while not self.stopped.wait(0.1):
            for h in self.replicas:
                if h.argv is None:
                    continue
                proc = h.proc
                if proc is not None and proc.poll() is not None:
                    code = proc.returncode
                    with h.lock:
                        h.proc = None
                        h.dead = True
                        h.healthy = False
                        h.exits += 1
                        h.last_exit_code = code
                        h.pending_restart = True
                        # backoff bookkeeping stays inside the lock: the
                        # probe thread's re-admission reset (_note_routable)
                        # races this doubling, and a lost update either
                        # stalls the restart or hot-loops it
                        backoff = h.backoff_s
                        h.next_restart_at = time.monotonic() + backoff
                        h.backoff_s = min(backoff * 2.0,
                                          self.restart_backoff_max_s)
                    self._bump("exits")
                    self._event({"tier_replica_exit": 1.0,
                                 "replica_slot": float(h.slot),
                                 "exit_code": float(code if code is not None
                                                    else -1)})
                    print(f"[tier] replica {h.rid} exited code={code} — "
                          f"restart in {backoff:g}s", file=sys.stderr,
                          flush=True)
                    self._note_routable(h, f"process exit code={code}")
                if (h.proc is None and h.pending_restart
                        and time.monotonic() >= h.next_restart_at
                        and not self.stopped.is_set()):
                    self._launch(h)

    # -- health --------------------------------------------------------------

    def _health_loop(self) -> None:
        while not self.stopped.wait(self.health_every_s):
            for h in self.replicas:
                self._probe(h)

    def _probe(self, h: ReplicaHandle) -> None:
        if h.argv is not None and h.proc is None:
            return     # nothing on that port; the supervisor owns the slot
        wait = h.breaker.reject_for()
        if wait is not None:
            # open circuit mid-cooldown: no probe this tick (reject_for
            # itself flips open->half_open and grants the probe slot when
            # the cooldown lapses)
            self._note_routable(h, "breaker open")
            return
        js = None
        try:
            code, js = _http_json(h.url + "/healthz",
                                  timeout=self.probe_timeout_s)
            ok = code == 200 and isinstance(js, dict)
        except Exception:  # noqa: BLE001 — any transport failure is a miss
            ok = False
        h.breaker.record(ok)
        if ok:
            models = js.get("models") or {}
            with h.lock:
                h.dead = False
                h.healthy = True
                h.draining = js.get("status") == "draining"
                h.queue_depth = int(js.get("queue_depth") or 0)
                h.workers = (sum(int(m.get("workers") or 1)
                                 for m in models.values()) or 1)
                h.last_health = js
                h.last_health_unix = time.time()
            self._note_routable(h, "draining" if h.draining else "")
        else:
            with h.lock:
                h.healthy = False
            self._note_routable(h, "health probe failed")

    def _roll_loop(self) -> None:
        while not self.stopped.wait(self.roll_every_s):
            self.roll.roll_once()

    # -- routing -------------------------------------------------------------

    def _pick(self, exclude) -> Optional[ReplicaHandle]:
        n = len(self.replicas)
        k = next(self._rr) % n      # rotate ties instead of pinning slot 0
        best, best_score = None, None
        for h in (self.replicas[k:] + self.replicas[:k]):
            if h in exclude or not h.routable:
                continue
            s = h.score()
            if best is None or s < best_score:
                best, best_score = h, s
        return best

    def forward_predict(self, path: str, body: bytes, headers_in) -> tuple:
        """Route + forward one predict request; returns
        (status, body_bytes, content_type, replica_or_None, request_id,
        attempts). Retries transport failures and replica-local refusals
        on the next admitted replica; authoritative answers (200/400/404)
        pass through."""
        rid = headers_in.get("X-Request-Id") or new_request_id()
        deadline_hdr = headers_in.get("X-Deadline-Ms")
        try:
            deadline_s = (float(deadline_hdr) / 1000.0 if deadline_hdr
                          else self.default_deadline_s)
        except ValueError:
            deadline_s = self.default_deadline_s
        t_end = time.monotonic() + deadline_s
        fwd_headers = {
            "Content-Type": headers_in.get("Content-Type",
                                           "application/json"),
            "X-Request-Id": rid,
        }
        if deadline_hdr:
            fwd_headers["X-Deadline-Ms"] = deadline_hdr
        self._bump("requests")
        tried: List[ReplicaHandle] = []
        last: Optional[tuple] = None     # retryable verdict kept as fallback
        attempts = 0
        while not self.stopped.is_set():
            h = self._pick(tried)
            if h is None:
                break
            remaining = t_end - time.monotonic()
            if remaining <= 0.01:
                break
            tried.append(h)
            attempts += 1
            if attempts > 1:
                self._bump("retries")
            timeout = remaining
            if self.attempt_timeout_s is not None and any(
                    o.routable for o in self.replicas
                    if o is not h and o not in tried):
                timeout = min(remaining, self.attempt_timeout_s)
            with h.lock:
                h.inflight += 1
            try:
                req = urllib.request.Request(
                    h.url + path, data=body, headers=fwd_headers,
                    method="POST")
                try:
                    with urllib.request.urlopen(
                            req, timeout=timeout) as resp:
                        data = resp.read()
                        h.breaker.record(True)
                        with h.lock:
                            h.routed += 1
                        return (resp.status, data,
                                resp.headers.get("Content-Type",
                                                 "application/json"),
                                h, rid, attempts)
                except urllib.error.HTTPError as e:
                    data = e.read()
                    ct = e.headers.get("Content-Type", "application/json")
                    if e.code in (500, 504):
                        # the replica's serving path failed on a live
                        # request: charge its breaker, try the next one
                        h.breaker.record(False)
                        with h.lock:
                            h.failures += 1
                        self._note_routable(h, f"http {e.code}")
                        last = (e.code, data, ct, h)
                        continue
                    if e.code == 503:
                        # replica-local refusal (draining / circuit_open /
                        # deadline_unmeetable): it ANSWERED — not a
                        # transport failure, but another replica may admit
                        try:
                            reason = str(json.loads(
                                data.decode()).get("error", ""))
                        except Exception:  # noqa: BLE001
                            reason = ""
                        if "drain" in reason.lower():
                            with h.lock:
                                h.draining = True
                            self._note_routable(h, "draining")
                        last = (e.code, data, ct, h)
                        continue
                    if e.code == 429:
                        # per-model backpressure: exactly the case where a
                        # less-loaded replica absorbs the spike
                        last = (e.code, data, ct, h)
                        continue
                    # 400/404/...: authoritative — the request itself is
                    # the problem; pass the replica's body through verbatim
                    h.breaker.record(True)
                    return (e.code, data, ct, h, rid, attempts)
                except Exception as e:  # noqa: BLE001 — URLError/reset/...
                    h.breaker.record(False)
                    with h.lock:
                        h.failures += 1
                    reason = getattr(e, "reason", e)
                    if isinstance(reason, ConnectionRefusedError) or \
                            isinstance(e, ConnectionRefusedError):
                        # dead socket: eject on the spot, no K-failure wait
                        with h.lock:
                            h.dead = True
                            h.healthy = False
                        self._note_routable(h, "connection refused")
                    else:
                        self._note_routable(h, f"transport: {type(e).__name__}")
                    continue
            finally:
                with h.lock:
                    h.inflight -= 1
        if last is not None:
            code, data, ct, h = last
            return (code, data, ct, h, rid, attempts)
        self._bump("no_replica")
        body503 = json.dumps({
            "error": "NoReplicaAvailable",
            "detail": "no admitted replica (all dead, draining, or "
                      "circuit-open) — retry after the next health window",
            "replicas": len(self.replicas),
            "routable": 0,
        }).encode()
        return (503, body503, "application/json", None, rid, attempts)

    # -- read endpoints ------------------------------------------------------

    def health_body(self) -> dict:
        reps = [h.describe() for h in self.replicas]
        routable = sum(1 for r in reps if r["routable"])
        served: List[str] = []
        for h in self.replicas:
            with h.lock:
                lh = h.last_health
            if lh and lh.get("models"):
                served = list(lh["models"])
                break
        status = ("ok" if routable == len(reps)
                  else "unavailable" if routable == 0 else "degraded")
        return {"status": status, "size": len(reps), "routable": routable,
                "served_models": served, "replicas": reps,
                # replicas whose autoscaler exhausted its workers and wants
                # another replica — the operator's (or a supervisor's)
                # add-a-slot signal, aggregated tier-wide
                "scale_out_wanted": [r["replica"] for r in reps
                                     if r.get("wants_scale_out")],
                "roll": self.roll.describe()}

    def stats_body(self) -> dict:
        with self._stats_lock:
            stats = dict(self.stats)
        return {**stats,
                "replicas": {h.rid: {"routed": h.routed,
                                     "failures": h.failures,
                                     "launches": h.launches,
                                     "inflight": h.inflight}
                             for h in self.replicas},
                "roll": self.roll.describe()}

    def metrics_text(self) -> str:
        texts: Dict[str, str] = {}
        for h in self.replicas:
            if h.dead or not h.healthy:
                continue
            try:
                req = urllib.request.Request(h.url + "/metrics")
                with urllib.request.urlopen(
                        req, timeout=self.probe_timeout_s) as resp:
                    texts[h.rid] = resp.read().decode()
            except Exception:  # noqa: BLE001 — scrape what answers
                continue
        merged = merge_expositions(texts)
        with self._stats_lock:
            stats = dict(self.stats)
        routable = sum(1 for h in self.replicas if h.routable)
        P = "deepvision_tier_"
        lines: List[str] = []
        _emit(lines, P + "replicas", "gauge",
              "Configured replica slots.", [("", {}, len(self.replicas))])
        _emit(lines, P + "routable_replicas", "gauge",
              "Replicas currently admitted for routing.",
              [("", {}, routable)])
        _emit(lines, P + "requests_total", "counter",
              "Requests accepted by the tier front door.",
              [("", {}, stats["requests"])])
        _emit(lines, P + "routed_total", "counter",
              "Requests answered, by replica.",
              [("", {"replica": h.rid}, h.routed) for h in self.replicas])
        _emit(lines, P + "retries_total", "counter",
              "Same-request retries on another replica.",
              [("", {}, stats["retries"])])
        _emit(lines, P + "no_replica_total", "counter",
              "Requests refused: no admitted replica.",
              [("", {}, stats["no_replica"])])
        _emit(lines, P + "replica_ejections_total", "counter",
              "Routing ejections (crash, wedge, drain, breaker).",
              [("", {}, stats["ejections"])])
        _emit(lines, P + "replica_readmissions_total", "counter",
              "Replicas re-admitted after ejection.",
              [("", {}, stats["readmissions"])])
        _emit(lines, P + "replica_restarts_total", "counter",
              "Supervised replica respawns, by replica.",
              [("", {"replica": h.rid}, max(0, h.launches - 1))
               for h in self.replicas])
        _emit(lines, P + "inflight", "gauge",
              "Router-side in-flight requests, by replica.",
              [("", {"replica": h.rid}, h.inflight)
               for h in self.replicas])
        return merged + "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *fmt_args):  # noqa: N802 — stdlib name
        pass

    def _send(self, code: int, body: bytes, content_type: str,
              extra: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            if v is not None:
                self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj, extra: Optional[dict] = None) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json",
                   extra)

    def do_GET(self):  # noqa: N802 — stdlib handler name
        router = self.server.router
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            body = router.health_body()
            return self._json(200 if body["status"] != "unavailable"
                              else 503, body)
        if path == "/stats":
            return self._json(200, router.stats_body())
        if path == "/metrics":
            text = router.metrics_text().encode()
            return self._send(200, text,
                              "text/plain; version=0.0.4; charset=utf-8")
        if path == "/trace":
            return self._json(200, chrome_trace(router.tracer))
        return self._json(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):  # noqa: N802 — stdlib handler name
        router = self.server.router
        path = self.path.split("?", 1)[0]
        if path == "/roll":
            return self._json(200, router.roll.roll_once())
        if path == "/predict" or path.startswith("/predict/"):
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            t0 = time.monotonic_ns()
            code, data, ct, h, rid, attempts = router.forward_predict(
                path, body, self.headers)
            router.tracer.add(
                "tier_route", "tier", t0, time.monotonic_ns() - t0,
                args={"request_id": rid, "status": code,
                      "attempts": attempts,
                      "replica": h.rid if h is not None else None})
            router._bump(f"responses_{code // 100}xx")
            extra = {"X-Request-Id": rid,
                     "X-Tier-Replica": h.rid if h is not None else None}
            if code == 503 and h is None:
                extra["Retry-After"] = max(
                    1, int(router.health_every_s + 0.999))
            return self._send(code, data, ct, extra)
        return self._json(404, {"error": f"unknown path {self.path!r}"})


# -- CLI ----------------------------------------------------------------------

def build_tier_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch.serve.tier",
        description="Replica-tier router: N supervised fleet-server "
                    "replicas behind one least-loaded front door with "
                    "circuit breaking, supervised restart, rolling "
                    "promotion, and merged /metrics.")
    p.add_argument("-m", "--model", required=True,
                   help="model name(s), comma separated — every replica "
                        "serves the same fleet")
    p.add_argument("--replicas", type=int, default=2,
                   help="replica process count (default 2)")
    p.add_argument("--port", type=int, default=8701,
                   help="router port (replica ports are OS-assigned)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--runs-root", default=None,
                   help="forwarded to replicas: per-model run dirs "
                        "(trained weights + hot-reload watching)")
    p.add_argument("--promote-gate", type=float, default=None,
                   help="forwarded to replicas: arm the accuracy gate; "
                        "candidates are then driven through the tier's "
                        "ROLLING promotion (POST /roll), replica by "
                        "replica")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--buckets", default=None,
                   help="forwarded to replicas (default: replica default)")
    p.add_argument("--max-batch", type=int, default=None)
    p.add_argument("--max-delay-ms", type=float, default=None)
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="forwarded to replicas as the default deadline")
    p.add_argument("--device", default="cuda",
                   help="forwarded to replicas: the torch device each "
                        "serves on (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--cache-dir", default=None, metavar="VALUE",
                   help="refused: it sets the JAX tier's shared XLA "
                        "compilation cache, which eager PyTorch has no "
                        "counterpart of (the kernel libraries' build cache "
                        "is shared already)")
    p.add_argument("--drain-grace", type=float, default=0.75,
                   help="forwarded to replicas: seconds /healthz says "
                        "'draining' before the batcher drain starts")
    p.add_argument("--health-every", type=float, default=0.25,
                   help="router health-poll period, seconds")
    p.add_argument("--probe-timeout", type=float, default=1.0,
                   help="deadline on each health probe (bounds wedge "
                        "detection latency)")
    p.add_argument("--attempt-timeout", type=float, default=0.0,
                   help="per-replica attempt cap, seconds (0 = off): with "
                        "other replicas available, a forward that exceeds "
                        "this retries elsewhere instead of burning the "
                        "whole client deadline on a wedged replica")
    p.add_argument("--tier-breaker-k", type=int, default=3,
                   help="consecutive per-replica failures that open its "
                        "routing circuit")
    p.add_argument("--tier-breaker-cooldown", type=float, default=1.0,
                   help="seconds an open replica circuit waits before a "
                        "half-open probe")
    p.add_argument("--restart-backoff", type=float, default=0.5,
                   help="initial supervised-restart backoff, doubling to "
                        "8x (reset on readmission)")
    p.add_argument("--roll-every", type=float, default=0.0,
                   help="seconds between automatic rolling-promotion "
                        "sweeps (0 = only on POST /roll)")
    p.add_argument("--log-dir", default=None,
                   help="JSONL dir for resilience_tier_* events")
    p.add_argument("--smoke", action="store_true",
                   help="boot the tier, run synthetic HTTP load through "
                        "the router, print one JSON verdict, exit")
    p.add_argument("--duration", type=float, default=4.0,
                   help="--smoke load duration, seconds")
    p.add_argument("--smoke-threads", type=int, default=4)
    p.add_argument("--kill-one", action="store_true",
                   help="--smoke only: SIGKILL one replica mid-load and "
                        "require zero failed responses + a supervised "
                        "readmission")
    return p


def _replica_argv(args, slot: int, port: int) -> List[str]:
    argv = [sys.executable, "-m", "deepvision_tpu_torch.serve.replica",
            "-m", args.model, "--port", str(port), "--host", args.host,
            "--replica-id", str(slot), "--device", args.device,
            "--drain-grace", str(args.drain_grace)]
    if args.runs_root:
        argv += ["--runs-root", args.runs_root]
    if args.promote_gate is not None:
        argv += ["--promote-gate", str(args.promote_gate)]
    if args.image_size is not None:
        argv += ["--image-size", str(args.image_size)]
    if args.buckets:
        argv += ["--buckets", args.buckets]
    if args.max_batch is not None:
        argv += ["--max-batch", str(args.max_batch)]
    if args.max_delay_ms is not None:
        argv += ["--max-delay-ms", str(args.max_delay_ms)]
    if args.workers is not None:
        argv += ["--workers", str(args.workers)]
    if args.deadline_ms is not None:
        argv += ["--deadline-ms", str(args.deadline_ms)]
    return argv


def build_tier(args) -> TierRouter:
    """Replica handles (supervised, OS-assigned ports) + router from
    parsed `build_tier_parser` args."""
    handles = []
    for slot in range(args.replicas):
        port = free_port(args.host)
        handles.append(ReplicaHandle(
            str(slot), f"http://{args.host}:{port}",
            argv=_replica_argv(args, slot, port), slot=slot,
            breaker_k=args.tier_breaker_k,
            breaker_cooldown_s=args.tier_breaker_cooldown))
    first_model = args.model.split(",")[0].strip()
    return TierRouter(
        handles, host=args.host, port=args.port,
        health_every_s=args.health_every,
        probe_timeout_s=args.probe_timeout,
        attempt_timeout_s=args.attempt_timeout or None,
        restart_backoff_s=args.restart_backoff,
        roll_model=first_model, roll_every_s=args.roll_every,
        log_dir=args.log_dir, device=args.device)


def _smoke_payload(model: str) -> bytes:
    """One valid single-instance predict body for `model`, shaped from its
    registered config (H, W, C)."""
    from ..configs import get_config
    d = get_config(model).data
    row = [[0.5] * d.channels for _ in range(d.image_size)]
    instance = [row for _ in range(d.image_size)]
    return json.dumps({"instances": [instance]}).encode()


def _run_smoke(router: TierRouter, args) -> int:
    n = len(router.replicas)
    if not router.wait_ready(n=n, timeout=600):
        print(json.dumps({"tier_smoke": "fail",
                          "error": "replicas never became routable"}),
              flush=True)
        return 1
    payload = _smoke_payload(args.model.split(",")[0].strip())
    url = f"http://{router.host}:{router.bound_port}/predict"
    stop = threading.Event()
    failures: List[tuple] = []
    ok_count = itertools.count()

    def client(i: int) -> None:
        while not stop.is_set():
            try:
                req = urllib.request.Request(
                    url, data=payload,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as resp:
                    resp.read()
                    next(ok_count)
            except Exception as e:  # noqa: BLE001 — every miss is a verdict
                failures.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(args.smoke_threads)]
    for t in threads:
        t.start()
    victim = None
    if args.kill_one:
        time.sleep(args.duration / 3.0)
        victim = router.replicas[0]
        if victim.proc is not None:
            print(f"[tier-smoke] SIGKILL replica {victim.rid} "
                  f"(pid {victim.proc.pid}) mid-load", file=sys.stderr,
                  flush=True)
            victim.proc.kill()
        time.sleep(2.0 * args.duration / 3.0)
        router.wait_ready(n=n, timeout=120)   # supervised back + readmitted
    else:
        time.sleep(args.duration)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    stats = router.stats_body()
    answered = next(ok_count)
    all_routed = all(h.routed > 0 for h in router.replicas)
    readmitted = (not args.kill_one) or (
        victim is not None and victim.routable and victim.launches >= 2)
    ok = (not failures and answered > 0 and all_routed and readmitted)
    print(json.dumps({
        "tier_smoke": "pass" if ok else "fail",
        "replicas": n, "answered": answered,
        "failed_responses": len(failures),
        "routed": {h.rid: h.routed for h in router.replicas},
        "retries": stats["retries"], "ejections": stats["ejections"],
        "readmissions": stats["readmissions"],
        "restarts": stats["restarts"],
        "killed": victim.rid if victim is not None else None,
        **({"first_failure": failures[0][1]} if failures else {}),
    }), flush=True)
    return 0 if ok else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_tier_parser()
    args = parser.parse_args(argv)
    if args.replicas < 1:
        parser.error(f"--replicas must be >= 1, got {args.replicas}")
    if args.kill_one and not args.smoke:
        parser.error("--kill-one is a --smoke option")
    if args.cache_dir is not None:
        parser.error("--cache-dir is not ported: it sets XLA's persistent "
                     "compilation cache, which the port's eager PyTorch has "
                     "no counterpart of; the kernel libraries' build cache "
                     "(ops/_build.py) is shared by every replica already")
    router = build_tier(args)
    router.start()
    try:
        if args.smoke:
            return _run_smoke(router, args)
        with GracefulShutdown(
                on_signal=router.stopped.set,
                what="draining replicas, then exiting 0") as gs:
            while not gs.requested and not router.stopped.is_set():
                time.sleep(0.2)
        return 0
    finally:
        router.close()


if __name__ == "__main__":
    raise SystemExit(main())
