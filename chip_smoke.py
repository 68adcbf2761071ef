"""Quickest proof that the PyTorch port runs on the card: `python3 chip_smoke.py`.

Needs one CUDA card, nvcc (or $CUDA_HOME/bin/nvcc) and no network; exits
non-zero on any failure and when no card is present. Imports nothing of
JAX and nothing of the JAX package. Phases, one line each or more:

1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
2. build every kernel of the port from csrc/ (one nvcc per source, all
   started together) and print the build seconds and nvcc's resource report;
3. each kernel against its plain PyTorch version on the card at the shapes
   the main path gives it (and ragged ones), with its time, the plain
   version's, the library call's (`library_ms`, a yardstick the port never
   calls) and the least time the card could take (`bound_ms`);
4. the slice: `vit_small` at full width served by the port's own
   `serve.cli.build_server` on `cuda` — synthetic `_smoke` load, then
   `POST /predict` over 127.0.0.1 — with every answer held against
   `engine.reference()`, a small input held against the same weights on
   the CPU, and the kernels' launch counts, zeroed just before, showing
   that every dispatch went through them.

The line before the last is a JSON object with one record per kernel; the
last is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.models import build_model
from deepvision_tpu_torch.ops import _build
from deepvision_tpu_torch.ops.attention import (flash_attention,
                                                flash_attention_reference)
from deepvision_tpu_torch.serve.cli import _smoke, build_parser, build_server
from deepvision_tpu_torch.serve.server import InferenceServer

MODEL = "vit_small"
BUCKETS = (1, 8, 32)
# published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs its plain version: f32 differs only in summation order (the
# plain version's matmuls run in full f32: TF32 is switched off below);
# bf16 inputs with f32 accumulation differ by at most ~1 bf16 rounding of
# the output
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# served answers vs engine.reference(): both run the same bf16 model on
# the card; they differ only where cuBLAS picks another GEMM for the padded
# bucket than for the exact batch, i.e. in bf16 roundings of activations
SERVE_TOL = 5e-2
# card (bf16, flash kernel) vs CPU (bf16, the kernel's plain version) on
# the same seeded weights, relative to the largest logit: bf16 keeps ~0.4%,
# and activations rounded after differently ordered GEMM sums compound over
# depth 8
CPU_RTOL = 5e-2


def phase(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of `fn` over `iters` launches, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(shape, dtype):
    """Least time for softmax(QK^T)V on `shape`: Q, K, V read once and O
    written once, against 2 products of 2*B*H*N*N*D operations."""
    b, h, n, d = shape
    nbytes = 4 * b * h * n * d * torch.finfo(dtype).bits // 8
    flops = 4 * b * h * n * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_attention(shape, dtype, gen, timed: bool) -> dict:
    q, k, v = (torch.randn(shape, generator=gen).to("cuda", dtype)
               for _ in range(3))
    out = flash_attention(q, k, v)
    ref = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    if out.shape != q.shape or out.dtype != dtype:
        raise AssertionError(f"flash_attention gave {tuple(out.shape)} "
                             f"{out.dtype} for {tuple(shape)} {dtype}")
    err = (out.float() - ref.float()).abs().max().item()
    rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err}
    line = f"flash_attention {rec['dtype']} {tuple(shape)}: max_abs_err={err:.3g}"
    if err > TOL[dtype] or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{line} exceeds {TOL[dtype]:g}")
    if timed:
        bound, bound_by = attention_bound(shape, dtype)
        rec.update(
            ms=time_ms(lambda: flash_attention(q, k, v)),
            plain_ms=time_ms(lambda: flash_attention_reference(q, k, v), 10),
            library_ms=time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v)),
            bound_ms=bound, bound_by=bound_by)
        line += (f" ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                 f"library_ms={rec['library_ms']:.4f} "
                 f"bound_ms={bound:.4f} ({bound_by})")
    phase(line)
    return rec


def post(url: str, x: np.ndarray) -> np.ndarray:
    req = urllib.request.Request(
        url, data=json.dumps({"instances": x.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.asarray(json.loads(resp.read())["predictions"], np.float32)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build every kernel, in parallel
    t0 = time.perf_counter()
    _build.build(["flash_attention"])
    phase(f"kernels built in {time.perf_counter() - t0:.1f}s")
    for name, info in _build.BUILD_INFO.items():
        ptxas = " | ".join(ln.strip() for ln in info["ptxas"].splitlines()
                           if "registers" in ln or "spill" in ln)
        phase(f"{name}: {info['seconds']:.1f}s; {ptxas}")

    # 3. kernel against its plain version on the card
    gen = torch.Generator().manual_seed(0)
    cfg = get_config(MODEL)
    heads = cfg.model_kwargs["num_heads"]
    d = cfg.model_kwargs["embed_dim"] // heads
    n = (cfg.data.image_size // cfg.model_kwargs["patch_size"]) ** 2 + 1
    main_path = [check_attention((b, heads, n, d), torch.bfloat16, gen, True)
                 for b in BUCKETS]
    ragged = [check_attention((2, heads, nr, d), dt, gen, False)
              for nr in (5, 17, 300) for dt in (torch.float32, torch.bfloat16)]
    max_err = max(r["max_abs_err"] for r in main_path + ragged)

    # 4. the slice through the port's own server
    depth = cfg.model_kwargs["depth"]
    args = build_parser().parse_args(
        ["-m", MODEL, "--device", "cuda",
         "--buckets", ",".join(map(str, BUCKETS)), "--flush-every", "60"])
    server = build_server(args)          # engines built and warmed up
    engine = server.engine
    flash_attention.launches = 0         # counts of the main path only
    engine.dispatches = 0
    snap = _smoke(server, duration=4.0, n_threads=8)
    server.close()
    http = InferenceServer(engine=engine, max_delay_ms=5.0,
                           default_deadline_s=60.0, flush_every_s=60.0)
    t = threading.Thread(target=lambda: http.serve(port=0), daemon=True)
    t.start()
    if not http.ready.wait(60):
        raise RuntimeError("HTTP server did not start")
    base = f"http://127.0.0.1:{http.bound_port}"
    rs = np.random.RandomState(1)
    sent, answers = [], []
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        if health["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"/healthz device {health['device']!r}")
        for n_inst in (1, 2, 3, 4, 1):
            x = rs.randn(n_inst, *engine.example_shape).astype(np.float32)
            sent.append(x)
            answers.append(post(f"{base}/predict", x))
    finally:
        http.stop()
        t.join(timeout=60)
        http.close()
    launches, dispatches = flash_attention.launches, engine.dispatches
    phase(f"main path: {dispatches} dispatches, {launches} flash_attention "
          f"launches (depth {depth})")
    if dispatches == 0 or launches != depth * dispatches:
        raise AssertionError(f"flash_attention ran {launches} times for "
                             f"{dispatches} dispatches of depth {depth}")

    served_err = 0.0
    for x, y in zip(sent, answers):
        ref = engine.reference(x)
        if y.shape != (x.shape[0], cfg.data.num_classes) \
                or not np.isfinite(y).all():
            raise AssertionError(f"bad answer shape/values {y.shape}")
        served_err = max(served_err, float(np.abs(y - ref).max()))
    phase(f"HTTP answers vs engine.reference(): max_abs_err={served_err:.3g}")
    if served_err > SERVE_TOL:
        raise AssertionError(f"served answers differ by {served_err:g}")

    cpu_model = build_model(cfg).eval().cast_compute_weights_()
    x = rs.randn(2, *engine.example_shape).astype(np.float32)
    with torch.inference_mode():
        cpu_logits = cpu_model(torch.from_numpy(x)).numpy()
    cpu_err = float(np.abs(engine.reference(x) - cpu_logits).max())
    scale = max(1.0, float(np.abs(cpu_logits).max()))
    phase(f"card vs CPU plain path on 2 images: max_abs_err={cpu_err:.3g} "
          f"(logit scale {scale:.3g})")
    if not np.isfinite(cpu_logits).all() or cpu_err > CPU_RTOL * scale:
        raise AssertionError(f"card and CPU differ by {cpu_err:g}")

    for b in engine.buckets:
        phase(f"measure_batch_ms bucket {b}: {engine.measure_batch_ms(b, 20):.3f}")
    phase(f"smoke: {snap['requests']:.0f} requests, "
          f"p50_ms={snap.get('p50_ms', float('nan')):.3f} "
          f"p99_ms={snap.get('p99_ms', float('nan')):.3f} "
          f"images_per_sec={snap['images_per_sec']:.1f}; HTTP: {len(sent)} "
          f"requests")

    b32 = main_path[-1]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "deepvision_tpu_torch/csrc/flash_attention.cu",
        "replaces": "deepvision_tpu/ops/attention.py:73",
        "launches": launches, "max_abs_err": max_err,
        "ms": b32["ms"], "plain_ms": b32["plain_ms"],
        "bound_ms": b32["bound_ms"], "bound_by": b32["bound_by"],
        "library_ms": b32["library_ms"], "shape": b32["shape"],
        "dtype": b32["dtype"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
