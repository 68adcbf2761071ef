"""`python -m deepvision_tpu_torch.serve` — the port's serving entry point
(port of deepvision_tpu/serve/cli.py).

    # HTTP serving on the card (POST /predict; SIGTERM drains)
    python -m deepvision_tpu_torch.serve -m vit_small

    # self-driving synthetic load, one JSON summary line, exit 0
    python -m deepvision_tpu_torch.serve -m vit_small --smoke
    python -m deepvision_tpu_torch.serve -m vit_tiny --smoke --device cpu

Weights are random, drawn from each config's seed; checkpoint restore, hot
reload, promotion, int8, meshes and autoscaling are still to port
(ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Optional, Sequence

from ..core.resilience import GracefulShutdown


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch.serve",
        description="Dynamic-batching inference fleet over the port's model "
                    "zoo (shape-bucketed predict, multi-model routing)")
    p.add_argument("-m", "--model", default=None,
                   help="registered config name, or a comma-separated list "
                        "to serve a fleet (first name is the default model "
                        "bare POST /predict hits)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; cpu runs "
                        "the kernels' plain versions)")
    p.add_argument("--buckets", default="1,8,32",
                   help="comma-separated batch buckets (max-batch is "
                        "appended; default 1,8,32)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="coalescing cap = largest bucket (default: largest "
                        "of --buckets)")
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="micro-batching deadline: a request waits at most "
                        "this long for batch-mates (p99 floor; default 5)")
    p.add_argument("--max-queue", type=int, default=1024,
                   help="backpressure: per-model pending-example cap before "
                        "submits are rejected with 429 (default 1024)")
    p.add_argument("--deadline-ms", type=float, default=10000.0,
                   help="default request deadline (client 'deadline_ms' "
                        "overrides per request): admission control refuses "
                        "at the door (503 + Retry-After) when the queue "
                        "says it is unmeetable, and the result wait "
                        "answers 504 on expiry (default 10000 = 10s)")
    p.add_argument("--log-dir", default=None,
                   help="directory for serve.jsonl (metric flushes and "
                        "resilience_ events); default: console only")
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--flush-every", type=float, default=10.0,
                   help="seconds between periodic metric flushes")
    p.add_argument("--smoke", action="store_true",
                   help="drive synthetic in-process load (round-robin over "
                        "the fleet) instead of HTTP; print one JSON summary "
                        "line and exit 0")
    p.add_argument("--duration", type=float, default=2.0,
                   help="--smoke load duration in seconds")
    p.add_argument("--load-threads", type=int, default=8,
                   help="--smoke concurrent synthetic clients")
    return p


def _smoke(server, duration: float, n_threads: int) -> dict:
    """Closed-loop synthetic clients round-robined over the fleet's
    models; SIGTERM drains early and still exits 0. Pass requires EVERY
    served model to have answered requests."""
    import numpy as np

    from .batcher import RequestRejected, result_within

    models = list(server.fleet)
    stop = threading.Event()
    errors: list = []
    errors_lock = threading.Lock()

    def client(i: int) -> None:
        sm = models[i % len(models)]   # round robin: all models get load
        rs = np.random.RandomState(i)
        n = 1 + i % min(4, sm.engine.max_batch)  # mixed sizes: buckets
        x = rs.randn(n, *sm.engine.example_shape).astype(
            sm.engine.input_dtype)
        # deadline-bounded wait, same as the HTTP front door: a wedged
        # model fails the smoke in seconds
        deadline_s = sm.batcher.default_deadline_s or 30.0
        while not stop.is_set():
            try:
                result_within(sm.submit(x), deadline_s,
                              what=f"smoke[{sm.name}]")
            except RequestRejected:
                return  # drain/overload reached this client — done
            except Exception as e:  # noqa: BLE001 — smoke must report
                with errors_lock:  # (incl. DeadlineExpired: a wedged model
                    errors.append(e)   # is a FAILED smoke, loudly and fast)
                return

    with GracefulShutdown(on_signal=stop.set,
                          what="finishing in-flight batches, rejecting new "
                               "work, then exiting 0") as gs:
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(max(n_threads, len(models)))]
        print(f"[serve:{server.engine.name}] ready: synthetic load "
              f"x{len(threads)} over {server.fleet.names()} for "
              f"{duration:g}s on {server.engine.device_name} "
              f"(SIGTERM drains early)", flush=True)
        for t in threads:
            t.start()
        deadline = time.monotonic() + duration
        while time.monotonic() < deadline and not gs.requested:
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        snap = server.drain()
    per_model = server.fleet.snapshots()
    requests_total = sum(s.get("requests", 0) for s in per_model.values())
    starved = [n for n, s in per_model.items() if s.get("requests", 0) == 0]
    ok = not errors and snap.get("requests", 0) > 0 and not starved
    print(json.dumps({
        "serve_smoke": "pass" if ok else "fail",
        "model": server.engine.name,
        "device": server.engine.device_name,
        "models": {n: {"requests": s.get("requests", 0.0)}
                   for n, s in per_model.items()},
        "requests_total": round(float(requests_total), 1),
        "buckets": list(server.engine.buckets),
        **{k: round(float(v), 4) for k, v in snap.items()},
    }), flush=True)
    if not ok:
        detail = (f"errors: {errors[:1]!r}" if errors
                  else f"models with zero requests: {starved}" if starved
                  else "no requests completed")
        raise SystemExit(f"serve smoke failed: {detail}")
    return snap


def validate_args(parser: argparse.ArgumentParser, args) -> None:
    """The flag-coupling checks of every entry point built on
    `build_parser`."""
    if not args.model:
        parser.error("-m/--model is required (a registered config name)")
    names = [s.strip() for s in args.model.split(",") if s.strip()]
    if len(set(names)) != len(names):
        parser.error(f"duplicate model names in -m {args.model!r}")
    if args.deadline_ms <= 0:
        parser.error(f"--deadline-ms must be > 0, got {args.deadline_ms}")
    if args.duration <= 0:
        parser.error(f"--duration must be > 0, got {args.duration}")


def build_server(args):
    """Construct the serving stack (engines -> warmup -> fleet ->
    InferenceServer) from parsed `build_parser` args."""
    from .engine import PredictEngine
    from .fleet import ModelFleet
    from .server import InferenceServer

    names = [s.strip() for s in args.model.split(",") if s.strip()]
    try:
        buckets = tuple(int(b) for b in args.buckets.split(",") if b.strip())
    except ValueError:
        raise SystemExit(f"--buckets must be comma-separated ints, got "
                         f"{args.buckets!r}")
    fleet = ModelFleet()
    for name in names:
        engine = PredictEngine.from_config(
            name, device=args.device, buckets=buckets,
            max_batch=args.max_batch)
        engine.warmup()
        fleet.add(engine, max_batch=args.max_batch,
                  max_delay_ms=args.max_delay_ms,
                  max_queue_examples=args.max_queue,
                  default_deadline_s=args.deadline_ms / 1000.0)
    return InferenceServer(
        fleet=fleet, flush_every_s=args.flush_every, log_dir=args.log_dir,
        default_deadline_s=args.deadline_ms / 1000.0)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    validate_args(parser, args)
    server = build_server(args)
    try:
        if args.smoke:
            _smoke(server, args.duration, args.load_threads)
        else:
            server.serve(port=args.port, host=args.host)
    finally:
        server.close()
    return 0
