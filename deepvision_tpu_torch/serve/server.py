"""Inference server: fleet + batchers + metrics + lifecycle (port of
deepvision_tpu/serve/server.py; `/metrics`, `/trace` and `/reload` arrive
with the features behind them).

`InferenceServer.serve()` runs a stdlib `ThreadingHTTPServer` (each
connection gets a thread, and concurrent handler threads are exactly the
concurrency the micro-batchers coalesce) over a `ModelFleet`:

    POST /predict           {"instances": [[...HWC floats...], ...],
                             "deadline_ms": 250}   (deadline optional)
                            -> 200 {"predictions": [...]} from the DEFAULT
                               model (f32 outputs)
    POST /predict/<model>   -> same, routed by registry name; an unknown
                               name gets 404 with "served_models" in the body
                            -> 400 bad shape/body, 429 overloaded
                               (per-model backpressure)
                            -> 503 + Retry-After: admission control
                               (deadline unmeetable given the dispatch EMA
                               and queue), or 503 draining
                            -> 504 deadline expired AFTER acceptance — the
                               wait is deadline-bounded (client
                               "deadline_ms" or the --deadline-ms default)
    GET  /healthz           -> 200 status, the device the models run on,
                               per-model buckets, queue and provenance
    GET  /stats[/<model>]   -> 200 per-model ServingMetrics snapshot(s)

Every response carries an `X-Request-Id` (the client's, or a generated
one); refusals are logged as `resilience_` events under that id.

Graceful drain reuses the resilience SIGTERM/SIGINT contract
(core/resilience.GracefulShutdown): the first signal flips /healthz to
"draining" in the signal handler, then stops the accept path (new submits
get 503), finishes and answers every request already accepted, flushes
metrics, and returns. A second signal aborts.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..core.metrics import MetricsLogger
from ..core.resilience import GracefulShutdown, log_resilience_event
from .batcher import (DeadlineExpired, DeadlineUnmeetable, Draining,
                      Overloaded, result_within)
from .engine import PredictEngine
from .fleet import ModelFleet, UnknownModel

DRAIN_WHAT = ("finishing in-flight batches, rejecting new work, "
              "then exiting 0")

# HTTP-wait bound for requests that carry no deadline and hit a model with
# no configured default: generous, but BOUNDED
FALLBACK_DEADLINE_S = 30.0


class InferenceServer:
    """Owns the serving stack's lifecycle; `serve()` blocks until a signal
    (or `stop()`), drains, and returns the final metrics snapshot.

    Construct with a single `engine` (a one-model fleet is built around it)
    or a pre-built multi-model `fleet`; `engine` and `batcher` alias the
    DEFAULT model."""

    def __init__(self, engine: Optional[PredictEngine] = None, *,
                 fleet: Optional[ModelFleet] = None,
                 max_delay_ms: float = 5.0,
                 default_deadline_s: Optional[float] = None,
                 flush_every_s: float = 10.0,
                 log_dir: Optional[str] = None):
        if (engine is None) == (fleet is None):
            raise ValueError("pass exactly one of engine= or fleet=")
        if fleet is None:
            fleet = ModelFleet()
            fleet.add(engine, max_delay_ms=max_delay_ms,
                      default_deadline_s=default_deadline_s)
        self.fleet = fleet
        self.default_deadline_s = default_deadline_s
        default = fleet.default
        self.engine = default.engine
        self.batcher = default.batcher
        self.logger = MetricsLogger(log_dir, name="serve")
        self.flush_every_s = flush_every_s
        self._flush_step = 0
        self._event_lock = threading.Lock()
        self._event_seq = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.ready = threading.Event()   # set once the listener is bound
        self.bound_port: Optional[int] = None
        # the DE-ADMISSION flag: set the instant a drain is requested, before
        # the batcher drain starts rejecting work — /healthz flips first
        self.draining_flag = threading.Event()

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

    def stop(self) -> None:
        """Programmatic equivalent of one SIGTERM (tests/embedding use)."""
        self.draining_flag.set()   # de-admit BEFORE the drain starts
        self._stop.set()
        self._wake.set()

    def drain(self) -> dict:
        """Reject new work, finish everything accepted, flush metrics."""
        print(f"[serve:{self.engine.name}] graceful drain: rejecting new "
              f"work, finishing {self.fleet.queue_depth} queued examples "
              f"across {len(self.fleet)} model(s)", flush=True)
        self.fleet.drain()
        return self.flush_metrics(reset=False)

    def close(self) -> None:
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
            http_thread.start()
            self.ready.set()
            print(f"[serve:{self.engine.name}] listening on "
                  f"http://{host}:{self.bound_port} "
                  f"models={self.fleet.names()} "
                  f"default={self.engine.name} "
                  f"device={self.engine.device_name} "
                  f"max_delay_ms={self.batcher.max_delay * 1000:g}",
                  flush=True)
            while not (gs.requested or self._stop.is_set()):
                if self._wake.wait(self.flush_every_s):
                    self._wake.clear()   # signal/stop — re-check the flag
                    continue
                self.flush_metrics()     # quiet period: periodic flush
            self.draining_flag.set()
            # drain FIRST: handlers blocked on accepted futures still get
            # their answers while new submits 503; only then stop accepting
            # connections at all
            snap = self.drain()
            httpd.shutdown()
            httpd.server_close()
            http_thread.join(timeout=10)
        print(f"[serve:{self.engine.name}] drained cleanly", flush=True)
        return snap


def _make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        # per-request stderr lines are pure noise under load; the metrics
        # stream is the observability surface
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        request_id: Optional[str] = None

        def _send(self, code: int, obj, headers=None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self.request_id is not None:
                self.send_header("X-Request-Id", self.request_id)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

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
                self._send(404, {"error": str(e), "served_models": e.served})
                return None

        def _unknown_path(self) -> None:
            self._send(404, {"error": f"unknown path {self.path!r}",
                             "served_models": server.fleet.names()})

        def do_GET(self):
            self.request_id = (self.headers.get("X-Request-Id")
                               or uuid.uuid4().hex[:16])
            if self.path == "/healthz":
                d = server.fleet.default
                self._send(200, {
                    "status": ("draining"
                               if (server.draining_flag.is_set()
                                   or server.fleet.draining)
                               else "ok"),
                    "device": d.engine.device_name,
                    "queue_depth": server.fleet.queue_depth,
                    "model": d.name,
                    "buckets": list(d.engine.buckets),
                    "max_batch": d.batcher.max_batch,
                    "weights": d.engine.provenance,
                    "served_models": server.fleet.names(),
                    "models": server.fleet.describe(),
                })
            elif self.path == "/stats" or self.path.startswith("/stats/"):
                sm = self._resolve("/stats")
                if sm is None:
                    return
                snap = sm.snapshot()
                if self.path == "/stats":
                    snap["models"] = server.fleet.snapshots()
                self._send(200, snap)
            else:
                self._unknown_path()

        def do_POST(self):
            rid = self.request_id = (self.headers.get("X-Request-Id")
                                     or uuid.uuid4().hex[:16])
            if not self.path.startswith("/predict"):
                return self._unknown_path()
            sm = self._resolve("/predict")
            if sm is None:
                return
            t_in = time.monotonic()

            def refused(outcome: str) -> None:
                log_resilience_event(
                    server.logger, server.next_event_step(),
                    {f"serve_refused_{outcome}": 1.0}, request_id=rid)

            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                x = np.asarray(payload["instances"], np.float32)
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
                return self._send(400, {
                    "error": f"body must be JSON {{'instances': [...]"
                             f"[, 'deadline_ms': N]}}: {e}"})
            try:
                fut = sm.submit(x, deadline_s=deadline_s)
            except Overloaded as e:
                refused("overloaded")
                return self._send(429, {"error": str(e)})
            except DeadlineUnmeetable as e:
                refused("deadline_unmeetable")
                return self._send(
                    503, {"error": str(e), "model": sm.name,
                          "reason": "deadline_unmeetable",
                          "eta_ms": round(e.eta_s * 1000.0, 1)},
                    headers={"Retry-After":
                             f"{max(e.retry_after_s, 0.001):.3f}"})
            except Draining as e:
                refused("draining")
                return self._send(503, {"error": str(e),
                                        "reason": "draining"})
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            try:
                out = result_within(
                    fut, max(0.001, t_in + deadline_s - time.monotonic()),
                    what=f"predict[{sm.name}]")
            except DeadlineExpired as e:
                sm.metrics.observe_deadline_expired()
                refused("deadline_expired")
                return self._send(504, {"error": str(e), "model": sm.name,
                                        "reason": "deadline_expired",
                                        "deadline_ms":
                                            round(deadline_s * 1000.0, 1)})
            except Exception as e:  # noqa: BLE001 — a failed dispatch must
                refused("dispatch_error")           # not hang the client
                return self._send(500, {"error": repr(e)})
            self._send(200, {"predictions": np.asarray(out).tolist(),
                             "model": sm.name})

    return Handler
