"""`python -m deepvision_tpu_torch.serve` — the port's serving entry point
(port of deepvision_tpu/serve/cli.py).

    # HTTP serving on the card (POST /predict; SIGTERM drains)
    python -m deepvision_tpu_torch.serve -m vit_small

    # self-driving synthetic load, one JSON summary line, exit 0
    python -m deepvision_tpu_torch.serve -m vit_small --smoke
    python -m deepvision_tpu_torch.serve -m vit_tiny --smoke --device cpu

    # detection: yolov3 at 416 px answers each image's three decoded
    # scales (boxes, objectness, class probabilities)
    python -m deepvision_tpu_torch.serve -m yolov3 --buckets 1,8

    # the weights a training run left in its workdir (the EMA weights
    # where it kept them), verified against the checkpoint's integrity
    # manifest (a corrupt one is refused; --no-verify serves it flagged
    # verified: false); segmentation answers int32 class-id masks
    python -m deepvision_tpu_torch.serve -m unet_synthetic \
        --workdir runs/unet_synthetic

    # hot reload with accuracy-gated promotion: every 2 s the run dir is
    # polled for a newly verified epoch (POST /reload runs one sweep at
    # once); a candidate is shadow-scored against the live weights on a
    # pinned shard, promoted only if it scores at most 2 points worse,
    # canaried on --canary-frac of the traffic for --canary-window
    # seconds, then promoted or rolled back. Every request traced
    python -m deepvision_tpu_torch.serve -m lenet5 --device cpu \
        --workdir runs/lenet5 --reload-every 2 --promote-gate -0.02 \
        --trace-sample 1
    curl localhost:8700/metrics          # Prometheus text exposition
    curl localhost:8700/trace?secs=10    # Chrome trace JSON (Perfetto)
    curl -X POST localhost:8700/reload   # one reload sweep, its outcome

    # a fleet from a runs root (<runs-root>/<model> per model), with the
    # dispatcher pool autoscaled between 1 and 4 workers
    python -m deepvision_tpu_torch.serve -m vit_small,lenet5 \
        --runs-root runs --autoscale-every 1 --max-workers 4
    python -m deepvision_tpu_torch.serve --list-models --runs-root runs

    # the drift-triggered flywheel: a confirmed input drift fine-tunes a
    # bounded candidate into the run dir and ships it through the gate
    python -m deepvision_tpu_torch.serve -m vit_small --workdir runs/vit \
        --promote-gate -0.02 --flywheel-every 0.5

The rest of the serving flags: `--workers` (the pool's floor),
`--breaker-k` / `--breaker-cooldown` (the per-model circuit breaker),
`--no-trace`, `--drain-grace` (the de-admission window after SIGTERM),
`--image-size`. Five families serve: classification, detection (YOLO),
CenterNet, pose and segmentation; GAN configs are refused. The JAX CLI's
mesh and compilation-cache flags are refused by name (`LATER_FLAGS`).
Several replicas behind one router: serve/tier.py.

int8 serving: `--serve-precision int8` calibrates each model on its
pinned shard before any traffic and serves int8 only if the accuracy gate
passes (`--quant-gate`, default 0.02 of the watched metric); a refusal
keeps that model on bf16, a family with nothing to quantize prints
`int8 skipped` (serve/quantize.py):

    python -m deepvision_tpu_torch.serve -m vit_small \
        --serve-precision int8 --quant-gate 0.02
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from typing import Optional, Sequence

from ..core.resilience import GracefulShutdown

# flags of the JAX serving CLI whose features are not ported yet: each is
# refused by name with what brings it, never accepted and ignored
LATER_FLAGS = {
    "--model-parallel": "mesh serving (ROADMAP A6)",
    "--spatial-parallel": "mesh serving (ROADMAP A6)",
    "--hbm-gb": "mesh serving (ROADMAP A6)",
    "--compilation-cache": "no slice: it sets XLA's persistent compilation "
                           "cache, which the port's eager PyTorch has no "
                           "counterpart of",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch.serve",
        description="Dynamic-batching inference fleet over the port's model "
                    "zoo (shape-bucketed predict, multi-model routing, hot "
                    "weight reload, accuracy-gated promotion)")
    p.add_argument("-m", "--model", default=None,
                   help="registered config name, or a comma-separated list "
                        "to serve a fleet (first name is the default model "
                        "bare POST /predict hits; see --list-models)")
    p.add_argument("-c", "--checkpoint", default=None,
                   help="epoch number or 'latest' (needs --workdir; "
                        "single-model only)")
    p.add_argument("--workdir", default=None,
                   help="training workdir to restore weights from (EMA "
                        "weights win when present); single-model only — a "
                        "fleet resolves per-model workdirs under "
                        "--runs-root. Omit both for random-weight serving")
    p.add_argument("--runs-root", default=None,
                   help="runs root holding one <runs-root>/<model> workdir "
                        "per served model; models with a restorable "
                        "checkpoint there serve it (and hot-reload from "
                        "it), the rest serve random weights with a warning")
    p.add_argument("--reload-every", type=float, default=0.0,
                   metavar="SECS",
                   help="hot weight reload: poll each model's run dir every "
                        "SECS seconds for new committed epochs; a candidate "
                        "swaps in only after its integrity manifest "
                        "verifies (corrupt candidates are refused and "
                        "logged, old weights keep serving). 0 disables the "
                        "poller (default); POST /reload runs one sweep "
                        "either way")
    p.add_argument("--promote-gate", type=float, default=None,
                   metavar="DELTA",
                   help="accuracy-gated promotion: shadow-eval a verified "
                        "candidate against the live weights on a pinned "
                        "shard and promote only if the watched metric "
                        "delta (top-1 / mIoU / box count / PCK) is >= "
                        "DELTA (e.g. -0.02 = at most 2 points worse), then "
                        "canary a traffic fraction and roll back on a "
                        "dispatch-time or error regression. Needs "
                        "--reload-every or --flywheel-every; unset = direct "
                        "integrity-verified swap (default)")
    p.add_argument("--canary-frac", type=float, default=0.05,
                   metavar="FRAC",
                   help="fraction of live traffic routed to the candidate "
                        "generation during the canary window (default "
                        "0.05; per-generation batches, never mixed)")
    p.add_argument("--canary-window", type=float, default=5.0,
                   metavar="SECS",
                   help="canary decision window: how long candidate and "
                        "baseline traffic are compared before promote or "
                        "rollback (default 5)")
    p.add_argument("--flywheel-every", type=float, default=0.0,
                   metavar="SECS",
                   help="drift-triggered continuous training: every SECS "
                        "seconds compare the live inputs and the watched "
                        "metric against the pinned calibration shard; a "
                        "drift confirmed over consecutive windows "
                        "fine-tunes a bounded candidate from the run dir "
                        "and ships it through the --promote-gate shadow "
                        "and canary pipeline, with exponential backoff and "
                        "a circuit after repeated refusals. Needs "
                        "--promote-gate; 0 disables (default)")
    p.add_argument("--serve-precision", choices=("bf16", "int8"),
                   default="bf16",
                   help="serving precision: bf16, the full-precision rung "
                        "(default; a config pinned to f32 computes in f32), "
                        "or int8: each model is calibrated on its pinned "
                        "shard and flipped to int8 ONLY if the accuracy "
                        "gate passes; a regression beyond --quant-gate "
                        "refuses loudly and keeps serving bf16 (decision "
                        "on /healthz and the resilience_ stream). "
                        "Per-request override: body {'precision': "
                        "'bf16'|'int8'}")
    p.add_argument("--quant-gate", type=float, default=0.02,
                   metavar="DELTA",
                   help="int8 accuracy gate: the watched metric (top-1 / "
                        "mIoU / box count / PCK) may be at most DELTA "
                        "worse at int8 than bf16 on the pinned shard "
                        "(default 0.02 = 2 points); beyond it the model "
                        "serves bf16 and the refusal is logged")
    for flag, why in LATER_FLAGS.items():
        p.add_argument(flag, default=None, metavar="VALUE",
                       help=f"refused: {why}")
    p.add_argument("--image-size", type=int, default=None,
                   help="serving resolution (default: each config's)")
    p.add_argument("--no-verify", action="store_true",
                   help="serve weights whose checkpoint fails (or skips) "
                        "integrity verification — by default a corrupt "
                        "checkpoint REFUSES to serve "
                        "(CheckpointCorruptionError; audit with `python -m "
                        "deepvision_tpu_torch fsck <workdir>`); legacy "
                        "workdirs with no manifests always serve, flagged "
                        "verified:false on /healthz")
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
    p.add_argument("--workers", type=int, default=1,
                   help="dispatcher workers per model sharing its engine "
                        "(default 1; the autoscale floor)")
    p.add_argument("--max-workers", type=int, default=4,
                   help="autoscale ceiling per model (default 4); a worker "
                        "is a thread and a reference, no weight copied")
    p.add_argument("--autoscale-every", type=float, default=0.0,
                   metavar="SECS",
                   help="shed-driven autoscaling: sample per-model "
                        "shed/p99/queue signals every SECS seconds and "
                        "scale the dispatcher pool between --workers and "
                        "--max-workers, with hysteresis; every decision on "
                        "/healthz and the resilience_ stream. 0 disables "
                        "(default)")
    p.add_argument("--deadline-ms", type=float, default=10000.0,
                   help="default request deadline (client 'deadline_ms' "
                        "overrides per request): admission control refuses "
                        "at the door (503 + Retry-After) when the queue "
                        "says it is unmeetable, and the result wait "
                        "answers 504 on expiry (default 10000 = 10s)")
    p.add_argument("--breaker-k", type=int, default=5,
                   help="circuit breaker: consecutive dispatch errors that "
                        "open a model's circuit (fail-fast 503 naming the "
                        "model; default 5)")
    p.add_argument("--breaker-cooldown", type=float, default=5.0,
                   metavar="SECS",
                   help="circuit breaker: seconds an open circuit waits "
                        "before admitting one half-open probe (default 5)")
    p.add_argument("--trace-sample", type=float, default=None,
                   metavar="FRAC",
                   help="per-request span sampling rate behind GET /trace "
                        "(default: DEEPVISION_TRACE_SAMPLE or 0.1). "
                        "Requests carrying an X-Request-Id header are "
                        "always sampled")
    p.add_argument("--no-trace", action="store_true",
                   help="disable span tracing: GET /trace serves an empty "
                        "ring and the request path pays one branch")
    p.add_argument("--drain-grace", type=float, default=0.0,
                   metavar="SECS",
                   help="graceful-drain de-admission window: after SIGTERM "
                        "/healthz reads 'draining' at once, and the server "
                        "keeps accepting and answering for SECS seconds "
                        "before new work is refused (default 0)")
    p.add_argument("--log-dir", default=None,
                   help="directory for serve.jsonl (metric flushes and "
                        "resilience_ events); default: the workdir or runs "
                        "root, else console only")
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
    p.add_argument("--list-models", action="store_true",
                   help="list the registered configs, whether each serves, "
                        "and the newest restorable checkpoint under "
                        "--runs-root (default runs/), and exit")
    return p


def restorable_epoch(runs_root: str, name: str) -> Optional[int]:
    """Newest committed checkpoint epoch under `<runs_root>/<name>/ckpt`,
    or None — what `--list-models` annotates and what decides whether a
    fleet member serves trained weights or a random init."""
    from ..core import integrity
    epochs = integrity.committed_epochs(
        os.path.join(runs_root, name, "ckpt"))
    return epochs[-1] if epochs else None


def _list_models(args) -> None:
    """One line per registered config: family, model, whether it serves,
    and the newest restorable checkpoint epoch under the runs root."""
    from .. import configs
    root = args.runs_root or "runs"
    for name, cfg in configs.CONFIGS.items():
        if cfg.family == "gan":
            servable, ckpt = "-", "-"
        else:
            epoch = restorable_epoch(root, name)
            servable = "yes"
            ckpt = f"epoch {epoch}" if epoch is not None else "-"
        print(f"{name:24s} family={cfg.family:16s} model={cfg.model:16s} "
              f"servable={servable:3s} ckpt={ckpt}")


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
        server.start_control_loops()
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
        "models": {n: {"requests": s.get("requests", 0.0),
                       "weights_epoch": s["weights"].get("checkpoint_epoch"),
                       "reloads": server.fleet.get(n).describe()["reload"]
                                  ["reloads"]}
                   for n, s in per_model.items()},
        "requests_total": round(float(requests_total), 1),
        "buckets": list(server.engine.buckets),
        # a flywheel-armed smoke's state machine and episode outcomes
        **({"flywheel": {fw.sm.name: {"state": fw.state, **fw.counters}
                         for fw in server.flywheels}}
           if server.flywheels else {}),
        **{k: round(float(v), 4) for k, v in snap.items()},
    }), flush=True)
    if not ok:
        detail = (f"errors: {errors[:1]!r}" if errors
                  else f"models with zero requests: {starved}" if starved
                  else "no requests completed")
        raise SystemExit(f"serve smoke failed: {detail}")
    return snap


def validate_args(parser: argparse.ArgumentParser, args,
                  require_reload_for_gate: bool = True) -> None:
    """The flag-coupling checks of every entry point built on
    `build_parser` (this CLI, the tier replica in serve/replica.py), and
    the refusal of the flags later slices bring.
    `require_reload_for_gate=False` lets --promote-gate stand without
    --reload-every: a tier replica arms the gate but is driven through
    `POST /reload` by the router's rolling promotion."""
    for flag, why in LATER_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            parser.error(f"{flag} is not ported yet: it arrives with {why}")
    if not args.model:
        parser.error("-m/--model is required (see --list-models)")
    names = [s.strip() for s in args.model.split(",") if s.strip()]
    if len(set(names)) != len(names):
        parser.error(f"duplicate model names in -m {args.model!r}")
    if len(names) > 1 and args.workdir:
        parser.error("--workdir is single-model; a fleet resolves "
                     "per-model workdirs under --runs-root")
    if len(names) > 1 and args.checkpoint:
        parser.error("-c/--checkpoint is single-model; a fleet serves each "
                     "model's latest verified checkpoint")
    if args.checkpoint is not None and args.workdir is None:
        parser.error("-c/--checkpoint needs --workdir")
    if not 0.0 < args.canary_frac <= 1.0:
        parser.error(f"--canary-frac must be in (0, 1], got "
                     f"{args.canary_frac}")
    if args.canary_window < 0:
        parser.error(f"--canary-window must be >= 0, got "
                     f"{args.canary_window}")
    # the gate evaluates the candidates the hot-reload poller finds, or
    # those the flywheel commits (its own reloader proposes them)
    if (require_reload_for_gate and args.promote_gate is not None
            and not args.reload_every and not args.flywheel_every):
        parser.error("--promote-gate needs --reload-every (or "
                     "--flywheel-every): promotion evaluates the candidates "
                     "the hot-reload poller finds")
    if args.flywheel_every < 0:
        parser.error(f"--flywheel-every must be >= 0, got "
                     f"{args.flywheel_every}")
    if args.flywheel_every and args.promote_gate is None:
        parser.error("--flywheel-every needs --promote-gate: the flywheel "
                     "only ships retrained candidates through the shadow/"
                     "canary promotion pipeline, never a direct swap")
    if args.reload_every < 0:
        parser.error(f"--reload-every must be >= 0, got "
                     f"{args.reload_every}")
    if args.workers < 1:
        parser.error(f"--workers must be >= 1, got {args.workers}")
    if args.max_workers < args.workers:
        parser.error(f"--max-workers ({args.max_workers}) must be >= "
                     f"--workers ({args.workers})")
    if args.autoscale_every < 0:
        parser.error(f"--autoscale-every must be >= 0, got "
                     f"{args.autoscale_every}")
    if args.deadline_ms <= 0:
        parser.error(f"--deadline-ms must be > 0, got {args.deadline_ms}")
    if args.breaker_k < 1:
        parser.error(f"--breaker-k must be >= 1, got {args.breaker_k}")
    if args.breaker_cooldown <= 0:
        parser.error(f"--breaker-cooldown must be > 0, got "
                     f"{args.breaker_cooldown}")
    if args.drain_grace < 0:
        parser.error(f"--drain-grace must be >= 0, got {args.drain_grace}")
    if args.trace_sample is not None and not 0.0 <= args.trace_sample <= 1.0:
        parser.error(f"--trace-sample must be in [0, 1], got "
                     f"{args.trace_sample}")
    if args.image_size is not None and args.image_size < 1:
        parser.error(f"--image-size must be >= 1, got {args.image_size}")
    if args.duration <= 0:
        parser.error(f"--duration must be > 0, got {args.duration}")
    if args.quant_gate < 0:
        parser.error(f"--quant-gate must be >= 0, got {args.quant_gate}")


def build_server(args, replica_id: Optional[str] = None):
    """Construct the serving stack (engines -> warmup -> fleet ->
    InferenceServer) from parsed `build_parser` args. Shared by `main` and
    the tier replica (serve/replica.py), so a replica behind the router is
    the standalone server; `replica_id` is its slot, echoed on /healthz."""
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
        workdir = args.workdir
        if workdir is None and args.runs_root:
            candidate = os.path.join(args.runs_root, name)
            if restorable_epoch(args.runs_root, name) is not None:
                workdir = candidate
            else:
                print(f"[serve:{name}] WARNING: nothing restorable under "
                      f"{candidate!r} — serving RANDOM weights (hot reload "
                      f"stays armed for when training commits there)",
                      flush=True)
                workdir = (candidate if os.path.isdir(candidate)
                           else None)
        engine = PredictEngine.from_config(
            name, device=args.device, buckets=buckets,
            max_batch=args.max_batch, workdir=workdir,
            checkpoint=args.checkpoint, image_size=args.image_size,
            verify=not args.no_verify)
        engine.warmup()
        fleet.add(engine, workdir=workdir, max_batch=args.max_batch,
                  max_delay_ms=args.max_delay_ms,
                  max_queue_examples=args.max_queue,
                  workers=args.workers,
                  default_deadline_s=args.deadline_ms / 1000.0,
                  breaker_k=args.breaker_k,
                  breaker_cooldown_s=args.breaker_cooldown)
    server = InferenceServer(
        fleet=fleet, flush_every_s=args.flush_every,
        reload_every_s=args.reload_every,
        log_dir=args.log_dir or args.workdir or args.runs_root,
        promote_gate=args.promote_gate,
        canary_frac=args.canary_frac,
        canary_window_s=args.canary_window,
        max_workers=args.max_workers,
        autoscale_every_s=args.autoscale_every,
        flywheel_every_s=args.flywheel_every,
        default_deadline_s=args.deadline_ms / 1000.0,
        trace=not args.no_trace,
        trace_sample=args.trace_sample,
        drain_grace_s=args.drain_grace,
        replica_id=replica_id)
    if args.serve_precision == "int8":
        # arm and gate int8 for every model BEFORE traffic: calibration is
        # startup cost, never request cost. A refusal keeps that model on
        # bf16, loudly (stderr, the resilience_ stream, /healthz)
        from .quantize import arm_int8
        for sm in fleet:
            try:
                arm_int8(sm.engine, gate=args.quant_gate,
                         logger=server.logger)
            except ValueError as e:
                print(f"[serve:{sm.name}] int8 skipped: {e}", flush=True)
    return server


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.list_models:
        _list_models(args)
        return 0
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
