"""Inference server: fleet + batchers + metrics + reload + lifecycle (port
of deepvision_tpu/serve/server.py).

`InferenceServer.serve()` runs a stdlib `ThreadingHTTPServer` (each
connection gets a thread, and concurrent handler threads are exactly the
concurrency the micro-batchers coalesce) over a `ModelFleet`:

    POST /predict           {"instances": [[...HWC floats...], ...],
                             "deadline_ms": 250}   (deadline optional)
                            -> 200 {"predictions": [...], "model": ...,
                               "generation": "live" | "candidate",
                               "weights_epoch": N} from the DEFAULT model
                               (f32 outputs: a detector's three scales of
                               (boxes, objectness, class probabilities) as
                               nested lists)
    POST /predict/<model>   -> same, routed by registry name; an unknown
                               name gets 404 with "served_models" in the body
                            -> 400 bad shape/body, 429 overloaded
                               (per-model backpressure)
                            -> 503 + Retry-After: admission control
                               (deadline unmeetable given the dispatch EMA
                               and queue), or the model's circuit open (K
                               consecutive dispatch errors; the body names
                               the model); 503 draining
                            -> 504 deadline expired AFTER acceptance — the
                               wait is deadline-bounded (client
                               "deadline_ms" or the --deadline-ms default)
    POST /reload            -> 200 after ONE synchronous hot-reload sweep
                               (WeightReloader.check_once): new verified
                               epochs swap in, or run the shadow/canary
                               promotion pipeline when one is attached,
                               before the answer {"swapped", "watched",
                               "models"} carries the outcome
    GET  /healthz           -> 200 status ("ok" | "draining"), the device,
                               the tier replica id, per-model buckets,
                               queue, workers, provenance, reload outcomes,
                               autoscale decisions, breaker state, the
                               kernel libraries loaded, the promotion and
                               flywheel records
    GET  /stats[/<model>]   -> 200 per-model ServingMetrics snapshot(s)
    GET  /metrics           -> 200 Prometheus text exposition (0.0.4):
                               lifetime counters, queue/worker/breaker
                               gauges, fixed-bucket latency histograms,
                               `model`-labeled, monotone across scrapes
                               (obs/export.py)
    GET  /trace[?secs=N]    -> 200 Chrome trace-event JSON of the recent
                               span ring (the last N seconds; default all):
                               one request's admission -> queue_wait ->
                               batch -> device_dispatch -> response_write

Request ids: every request gets one — the client's `X-Request-Id` or a
generated one — echoed in EVERY response (200/400/429/503/504), stamped
into its spans, and carried with the span's `trace_ref` on any
`resilience_` event it triggers. A client-supplied id forces the trace
sampling (`trace_sample`, `trace=False` turns tracing off).

Overload control: when `autoscale_every_s > 0` a control loop
(serve/autoscale.py) resizes each model's dispatcher pool between
`workers` and `max_workers` from its shed, p99 and queue signals.

Hot weight reload (serve/reload.py): models built with a workdir are
watched for new integrity-verified epochs (`reload_every_s > 0` arms the
poller; `POST /reload` runs one sweep), which swap in atomically; with
`promote_gate` set each candidate first passes the accuracy gate and a
canary (serve/promote.py). With `flywheel_every_s > 0` each gated model
also gets a drift-triggered flywheel (flywheel/controller.py): a
confirmed input drift fine-tunes a bounded candidate, commits it to the
run dir and ships it through the same gate.

Replica faults (utils/faults.py `DEEPVISION_FAULT_REPLICA_CRASH` /
`_WEDGE`) are consulted at the top of every request, so the tier
router's ejection paths rehearse against a real replica process.

Graceful drain reuses the resilience SIGTERM/SIGINT contract
(core/resilience.GracefulShutdown): the first signal flips /healthz to
"draining" in the signal handler, strictly before any work is refused;
after `drain_grace_s` (the window in which a router polling /healthz stops
sending, while this server still answers everything) an in-flight canary
rolls back, the accept path stops (new submits get 503), every request
already accepted is answered, metrics flush, and `serve()` returns. A
second signal aborts.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..core.metrics import MetricsLogger
from ..core.resilience import GracefulShutdown, log_resilience_event
from ..obs.export import chrome_trace, render_prometheus
from ..obs.trace import Tracer, new_request_id
from ..utils.faults import FaultInjector
from .autoscale import AutoscaleController
from .batcher import (CircuitOpen, DeadlineExpired, DeadlineUnmeetable,
                      Draining, Overloaded, result_within)
from .engine import PRECISIONS, PredictEngine, tree_map
from .fleet import ModelFleet, UnknownModel
from .reload import WeightReloader

DRAIN_WHAT = ("finishing in-flight batches, rejecting new work, "
              "then exiting 0")

# HTTP-wait bound for requests that carry no deadline and hit a model with
# no configured default: generous, but BOUNDED
FALLBACK_DEADLINE_S = 30.0
#: the longest the main loop sleeps before it looks at the shutdown flag
MAIN_LOOP_TICK_S = 0.5


class InferenceServer:
    """Owns the serving stack's lifecycle; `serve()` blocks until a signal
    (or `stop()`), drains, and returns the final metrics snapshot.

    Construct with a single `engine` (a one-model fleet is built around it)
    or a pre-built multi-model `fleet`; `engine`, `batcher` and `metrics`
    alias the DEFAULT model."""

    def __init__(self, engine: Optional[PredictEngine] = None, *,
                 fleet: Optional[ModelFleet] = None,
                 max_batch: Optional[int] = None,
                 max_delay_ms: float = 5.0,
                 max_queue_examples: int = 1024,
                 workdir: Optional[str] = None,
                 flush_every_s: float = 10.0,
                 reload_every_s: float = 0.0,
                 log_dir: Optional[str] = None,
                 promote_gate: Optional[float] = None,
                 canary_frac: float = 0.05,
                 canary_window_s: float = 5.0,
                 workers: int = 1,
                 max_workers: int = 4,
                 autoscale_every_s: float = 0.0,
                 flywheel_every_s: float = 0.0,
                 default_deadline_s: Optional[float] = None,
                 breaker_k: int = 5,
                 breaker_cooldown_s: float = 5.0,
                 trace: bool = True,
                 trace_sample: Optional[float] = None,
                 trace_capacity: int = 16384,
                 drain_grace_s: float = 0.0,
                 replica_id: Optional[str] = None):
        if (engine is None) == (fleet is None):
            raise ValueError("pass exactly one of engine= or fleet=")
        if fleet is None:
            fleet = ModelFleet()
            fleet.add(engine, workdir=workdir, max_batch=max_batch,
                      max_delay_ms=max_delay_ms,
                      max_queue_examples=max_queue_examples,
                      workers=workers,
                      default_deadline_s=default_deadline_s,
                      breaker_k=breaker_k,
                      breaker_cooldown_s=breaker_cooldown_s)
        self.fleet = fleet
        self.default_deadline_s = default_deadline_s
        default = fleet.default
        self.engine = default.engine
        self.batcher = default.batcher
        self.metrics = default.metrics
        self.logger = MetricsLogger(log_dir or workdir, name="serve",
                                     device=self.engine.device)
        if promote_gate is not None:
            from .promote import attach_promoters
            attach_promoters(fleet, gate_min_delta=promote_gate,
                             canary_frac=canary_frac,
                             canary_window_s=canary_window_s,
                             logger=self.logger,
                             warn=lambda msg: print(msg, flush=True))
        self.reloader = WeightReloader(
            fleet, poll_every_s=reload_every_s, logger=self.logger)
        # one tracer behind /trace, shared by the HTTP handlers (request,
        # admission, response spans) and every model's dispatchers
        # (queue_wait, batch, dispatch spans); trace=False turns every
        # producer into one branch
        self.tracer = Tracer(capacity=trace_capacity, sample=trace_sample,
                             enabled=trace)
        self._event_lock = threading.Lock()
        self._event_seq = 0
        # every batcher and breaker logs onto the server's resilience_
        # stream: observer errors and breaker transitions are incident lines
        for sm in fleet:
            sm.batcher.logger = self.logger
            sm.batcher.tracer = self.tracer
            if sm.breaker is not None:
                sm.breaker.logger = self.logger
        self.autoscaler = AutoscaleController(
            list(fleet), interval_s=autoscale_every_s,
            min_workers=min(sm.batcher.workers for sm in fleet),
            max_workers=max(max_workers,
                            max(sm.batcher.workers for sm in fleet)),
            logger=self.logger)
        self.flush_every_s = flush_every_s
        self._flush_step = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.ready = threading.Event()   # set once the listener is bound
        self.bound_port: Optional[int] = None
        # the DE-ADMISSION flag: set the instant a drain is requested, before
        # the batcher drain starts rejecting work — /healthz flips first
        self.draining_flag = threading.Event()
        # how long a drain-requested server keeps accepting and answering
        # after flipping /healthz, before submits start answering 503
        self.drain_grace_s = float(drain_grace_s)
        # identity within a replica tier (serve/tier.py), echoed on /healthz
        # so the router knows which process answers a slot's port
        self.replica_id = replica_id
        # replica faults (utils/faults.py REPLICA_CRASH / REPLICA_WEDGE),
        # consulted at the top of every HTTP request; an inert injector
        # costs two None compares
        self.faults = FaultInjector.from_env()
        # drift-triggered continuous training (flywheel/), armed by
        # flywheel_every_s > 0: one controller per promotion-gated,
        # workdir-backed model, on the server's logger, tracer and fault
        # injector (DEEPVISION_FAULT_DRIFT_SHIFT)
        self.flywheels: list = []
        if flywheel_every_s > 0:
            from ..flywheel.controller import attach_flywheels
            attach_flywheels(fleet, logger=self.logger, tracer=self.tracer,
                             tick_every_s=flywheel_every_s,
                             faults=self.faults,
                             warn=lambda msg: print(msg, flush=True))
            self.flywheels = [sm.flywheel for sm in fleet
                              if sm.flywheel is not None]

    def next_event_step(self) -> int:
        """Monotone step counter for per-request resilience events logged
        from concurrent handler threads."""
        with self._event_lock:
            self._event_seq += 1
            return self._event_seq

    def flush_metrics(self, reset: bool = True) -> dict:
        """Flush one per-interval snapshot per model to the metrics stream;
        returns the default model's."""
        self._flush_step += 1
        single = len(self.fleet) == 1
        out: dict = {}
        for sm in self.fleet:
            snap = sm.metrics.snapshot(queue_depth=sm.batcher.queue_depth,
                                       reset=reset)
            prefix = "serve_" if single else f"serve_{sm.name}_"
            self.logger.log(self._flush_step, snap, prefix=prefix)
            if sm is self.fleet.default:
                out = snap
        return out

    # -- lifecycle ---------------------------------------------------------

    def start_control_loops(self) -> None:
        """Start the reload poller, the autoscaler and the flywheels (each
        only when its cadence is > 0): `serve()` does, and so does the
        CLI's `--smoke`."""
        self.reloader.start()
        self.autoscaler.start()
        for fw in self.flywheels:
            fw.start()

    def stop(self) -> None:
        """Programmatic equivalent of one SIGTERM (tests/embedding use)."""
        self.draining_flag.set()   # de-admit BEFORE the drain starts
        self._stop.set()
        self._wake.set()

    def drain(self) -> dict:
        """Stop the control loops, reject new work, finish everything
        accepted, flush metrics. An in-flight promotion canary is aborted
        FIRST: the candidate rolls back to the incumbent and the poller
        (blocked in its canary window) returns, so the reloader's join
        below does not wait out the window."""
        for sm in self.fleet:
            if sm.promoter is not None:
                sm.promoter.abort()
        for fw in self.flywheels:
            fw.stop()
        self.autoscaler.stop()
        self.reloader.stop()
        print(f"[serve:{self.engine.name}] graceful drain: rejecting new "
              f"work, finishing {self.fleet.queue_depth} queued examples "
              f"across {len(self.fleet)} model(s)", flush=True)
        self.fleet.drain()
        return self.flush_metrics(reset=False)

    def close(self) -> None:
        for sm in self.fleet:
            if sm.promoter is not None:
                sm.promoter.abort()
        for fw in self.flywheels:
            fw.stop()
        self.autoscaler.stop()
        self.reloader.stop()
        self.fleet.drain()
        self.logger.close()

    def serve(self, port: int = 8700, host: str = "127.0.0.1") -> dict:
        httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.bound_port = httpd.server_address[1]
        http_thread = threading.Thread(target=httpd.serve_forever,
                                       daemon=True, name="http-serve")

        def on_signal() -> None:
            # /healthz flips IN the signal handler, before the main loop has
            # even woken to start the batcher drain
            self.draining_flag.set()
            self._wake.set()

        with GracefulShutdown(on_signal=on_signal, what=DRAIN_WHAT) as gs:
            self.start_control_loops()
            http_thread.start()
            self.ready.set()
            print(f"[serve:{self.engine.name}] listening on "
                  f"http://{host}:{self.bound_port} "
                  f"models={self.fleet.names()} "
                  f"default={self.engine.name} "
                  f"device={self.engine.device_name} "
                  f"max_delay_ms={self.batcher.max_delay * 1000:g}",
                  flush=True)
            # waits of at most MAIN_LOOP_TICK_S: the kernel may deliver
            # SIGTERM to a busy handler thread, and its Python handler then
            # runs only once the main thread wakes on its own
            quiet_since = time.monotonic()
            while not (gs.requested or self._stop.is_set()):
                if self._wake.wait(MAIN_LOOP_TICK_S):
                    self._wake.clear()   # signal/stop — re-check the flag
                    quiet_since = time.monotonic()
                    continue
                if time.monotonic() - quiet_since >= self.flush_every_s:
                    self.flush_metrics()  # quiet period: periodic flush
                    quiet_since = time.monotonic()
            # de-admission grace: /healthz already says "draining", and in
            # this window the server still accepts and answers everything
            self.draining_flag.set()
            if self.drain_grace_s > 0:
                time.sleep(self.drain_grace_s)
            # drain FIRST: handlers blocked on accepted futures still get
            # their answers while new submits 503; only then stop accepting
            # connections at all
            snap = self.drain()
            httpd.shutdown()
            httpd.server_close()
            http_thread.join(timeout=10)
        print(f"[serve:{self.engine.name}] drained cleanly", flush=True)
        return snap


def kernel_launches() -> dict:
    """Each kernel wrapper's launch count in this process (ops/)."""
    from ..ops.attention import flash_attention
    from ..ops.best_iou import best_iou
    return {"flash_attention": flash_attention.launches,
            "best_iou": best_iou.launches}


def _make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        # per-request stderr lines are pure noise under load; the metrics
        # stream is the observability surface
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        # the request id assigned by the current do_GET/do_POST — echoed
        # on EVERY response this handler writes, refusals included
        request_id: Optional[str] = None

        def _assign_request_id(self) -> str:
            self.request_id = (self.headers.get("X-Request-Id")
                               or new_request_id())
            return self.request_id

        def _send(self, code: int, body: bytes, ctype: str,
                  headers=None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if self.request_id is not None:
                self.send_header("X-Request-Id", self.request_id)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj, headers=None) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json",
                       headers)

        def _resolve(self, root: str):
            """Map `/<root>` or `/<root>/<model>` to a ServedModel; answers
            the 404 (with the served-model list) itself and returns None
            when the path doesn't resolve."""
            name = None
            if self.path != root:
                if not self.path.startswith(root + "/"):
                    return self._unknown_path()
                name = self.path[len(root) + 1:]
            try:
                return server.fleet.get(name)
            except UnknownModel as e:
                self._json(404, {"error": str(e), "served_models": e.served})
                return None

        def _unknown_path(self) -> None:
            self._json(404, {"error": f"unknown path {self.path!r}",
                             "served_models": server.fleet.names()})

        def do_GET(self):
            server.faults.on_replica_request(predict=False)
            self._assign_request_id()
            if self.path == "/metrics":
                # counters come from lifetime stores: consecutive scrapes
                # are monotone
                return self._send(
                    200, render_prometheus(server.fleet).encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
            if self.path == "/trace" or self.path.startswith("/trace?"):
                q = urllib.parse.parse_qs(
                    urllib.parse.urlparse(self.path).query)
                try:
                    secs = float(q["secs"][0]) if "secs" in q else None
                except ValueError:
                    return self._json(400, {"error": "secs must be a "
                                                     "number"})
                return self._json(200, chrome_trace(server.tracer, secs))
            if self.path == "/healthz":
                d = server.fleet.default
                self._json(200, {
                    "status": ("draining"
                               if (server.draining_flag.is_set()
                                   or server.fleet.draining)
                               else "ok"),
                    "device": d.engine.device_name,
                    # identity and load, read by the tier router's
                    # least-loaded routing (serve/tier.py)
                    "replica": server.replica_id,
                    "queue_depth": server.fleet.queue_depth,
                    "model": d.name,
                    "buckets": list(d.engine.buckets),
                    "max_batch": d.batcher.max_batch,
                    "weights": d.engine.provenance,
                    # the int8 axis: the active precision and the gate's
                    # last decision, a refusal visible here and not only
                    # on stderr
                    "precision": d.engine.precision,
                    "quant": d.engine.quant_decision,
                    "served_models": server.fleet.names(),
                    "models": server.fleet.describe(),
                    # this process's kernel launches since it started:
                    # with each model's dispatches, the proof that its
                    # traffic ran through the kernels
                    "kernel_launches": kernel_launches(),
                })
            elif self.path == "/stats" or self.path.startswith("/stats/"):
                sm = self._resolve("/stats")
                if sm is None:
                    return
                snap = sm.snapshot()
                if self.path == "/stats":
                    snap["models"] = server.fleet.snapshots()
                self._json(200, snap)
            else:
                self._unknown_path()

        def do_POST(self):
            rid = self._assign_request_id()
            if self.path == "/reload":
                # ONE synchronous reload sweep (the tier's rolling
                # promotion drives it): the caller reads the outcome from
                # the answer instead of polling
                server.faults.on_replica_request(predict=False)
                try:
                    swapped = server.reloader.check_once()
                except Exception as e:  # noqa: BLE001 — the control plane
                    return self._json(500, {"error": repr(e)})  # answers
                return self._json(200, {
                    "swapped": swapped,
                    "watched": [sm.name for sm in server.reloader.models],
                    "models": server.fleet.describe(),
                })
            server.faults.on_replica_request(
                predict=self.path.startswith("/predict"))
            if not self.path.startswith("/predict"):
                return self._unknown_path()
            sm = self._resolve("/predict")
            if sm is None:
                return
            t_in = time.monotonic()
            tracer = server.tracer
            # this request's sampling decision: a client-supplied
            # X-Request-Id forces it; None records no span
            ctx = tracer.request_context(
                rid, forced="X-Request-Id" in self.headers)
            t_adm = t_in

            def refused(outcome: str, admission: bool = True) -> None:
                """A request turned away (429/503/504/500): log ONE
                resilience event under its id and, when sampled, close its
                span chain so the event joins the spans behind it.
                `admission=False` for failures after acceptance, whose
                admission span was already recorded."""
                trace_ref = None
                if ctx is not None:
                    now = time.monotonic()
                    if admission:
                        tracer.add("admission", "serve", int(t_adm * 1e9),
                                   int((now - t_adm) * 1e9),
                                   args={"request_id": rid,
                                         "model": sm.name,
                                         "outcome": outcome})
                    tracer.add("http_request", "serve", int(t_in * 1e9),
                               int((now - t_in) * 1e9),
                               args={"request_id": rid, "model": sm.name,
                                     "outcome": outcome},
                               span_id=ctx.root_id)
                    trace_ref = ctx.trace_ref
                log_resilience_event(
                    server.logger, server.next_event_step(),
                    {f"serve_refused_{outcome}": 1.0},
                    request_id=rid, trace_ref=trace_ref)

            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                x = np.asarray(payload["instances"], np.float32)
                # per-request precision ("bf16" / "int8"; absent = the
                # model's active one); an unarmed one answers 400 at submit
                precision = payload.get("precision")
                if precision is not None and precision not in PRECISIONS:
                    raise ValueError(
                        f"precision must be 'bf16' or 'int8', got "
                        f"{precision!r}")
                # request deadline: body "deadline_ms", else the
                # X-Deadline-Ms header, else the model's configured
                # default, else the server fallback — ALWAYS bounded
                deadline_ms = payload.get(
                    "deadline_ms", self.headers.get("X-Deadline-Ms"))
                if deadline_ms is not None:
                    deadline_s = float(deadline_ms) / 1000.0
                    if deadline_s <= 0:
                        raise ValueError(
                            f"deadline_ms must be > 0, got {deadline_ms}")
                else:
                    deadline_s = (sm.batcher.default_deadline_s
                                  or server.default_deadline_s
                                  or FALLBACK_DEADLINE_S)
            except (KeyError, TypeError, ValueError) as e:
                return self._json(400, {
                    "error": f"body must be JSON {{'instances': [...]"
                             f"[, 'deadline_ms': N]}}: {e}"})
            t_adm = time.monotonic()
            try:
                # routed through the promotion controller when one is
                # attached; admission control, backpressure and the
                # circuit breaker all refuse HERE, before anything queues
                fut = sm.submit(x, deadline_s=deadline_s,
                                precision=precision, trace=ctx)
                if ctx is not None:
                    tracer.add("admission", "serve", int(t_adm * 1e9),
                               int((time.monotonic() - t_adm) * 1e9),
                               args={"request_id": rid, "model": sm.name,
                                     "outcome": "accepted"})
            except Overloaded as e:
                refused("overloaded")
                return self._json(429, {"error": str(e)})
            except DeadlineUnmeetable as e:
                refused("deadline_unmeetable")
                return self._json(
                    503, {"error": str(e), "model": sm.name,
                          "reason": "deadline_unmeetable",
                          "eta_ms": round(e.eta_s * 1000.0, 1)},
                    headers={"Retry-After":
                             f"{max(e.retry_after_s, 0.001):.3f}"})
            except CircuitOpen as e:
                # fail-fast 503 naming the model whose dispatch path is
                # broken — the fleet's other models keep serving
                refused("circuit_open")
                return self._json(
                    503, {"error": str(e), "model": e.model,
                          "reason": "circuit_open"},
                    headers={"Retry-After":
                             f"{max(e.retry_after_s, 0.001):.3f}"})
            except Draining as e:
                refused("draining")
                return self._json(503, {"error": str(e),
                                        "reason": "draining"})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            try:
                out = result_within(
                    fut, max(0.001, t_in + deadline_s - time.monotonic()),
                    what=f"predict[{sm.name}]")
            except DeadlineExpired as e:
                sm.metrics.observe_deadline_expired()
                refused("deadline_expired", admission=False)
                return self._json(504, {"error": str(e), "model": sm.name,
                                        "reason": "deadline_expired",
                                        "deadline_ms":
                                            round(deadline_s * 1000.0, 1)})
            except Exception as e:  # noqa: BLE001 — a failed dispatch must
                refused("dispatch_error", admission=False)  # not hang the
                return self._json(500, {"error": repr(e)})  # client
            # every 200 names the weight generation that computed it and
            # that generation's checkpoint epoch, as the dispatch read them
            # with the weights (exact across a swap or a promotion)
            body = {"predictions": tree_map(
                        lambda a: np.asarray(a).tolist(), out),
                    "model": sm.name,
                    "generation": fut.generation,
                    "weights_epoch": fut.weights.get("checkpoint_epoch")}
            if ctx is None:
                return self._json(200, body)
            t_w = time.monotonic()
            self._json(200, body)
            now = time.monotonic()
            tracer.add("response_write", "serve", int(t_w * 1e9),
                       int((now - t_w) * 1e9),
                       args={"request_id": rid, "model": sm.name})
            # the root span last: its chain (admission -> queue_wait ->
            # batch -> device_dispatch -> response_write) carries request_id
            tracer.add("http_request", "serve", int(t_in * 1e9),
                       int((now - t_in) * 1e9),
                       args={"request_id": rid, "model": sm.name,
                             "status": 200},
                       span_id=ctx.root_id)

    return Handler
