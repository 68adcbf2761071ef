"""Quickest proof that the PyTorch port runs on the card: `python3 chip_smoke.py`.

Needs one CUDA card, nvcc (or $CUDA_HOME/bin/nvcc) and no network; exits
non-zero on any failure and when no card is present. Imports nothing of
JAX and nothing of the JAX package. Phases, one line each or more:

1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
2. build every kernel of the port from csrc/ (one nvcc per source, all
   started together) and print the build seconds, ptxas's registers, shared
   memory and spills per kernel function, and the count of tensor-core
   instructions (`HMMA`) in each function's SASS (`cuobjdump -sass`) — the
   bf16 flash-attention kernels must have some; for the best-IoU kernel
   also its SASS instruction count, its divisions (`MUFU.RCP`) and
   min/max (`FMNMX`), and the length of its innermost loop per pair;
3. each kernel against its plain PyTorch version on the card at the shapes
   the main paths give it (vit_small's attention both contiguous and in
   the model's strided head-split layout) and at ragged and misaligned
   ones, with two times: `ms`, the host loop of 50 wrapper calls between
   CUDA events (Python dispatch included), and `device_ms`, 50 launches
   captured in one CUDA graph and replayed between CUDA events; beside
   them the plain version's time, the library call's (`library_ms` and
   `library_device_ms`, a yardstick the port never calls; none exists for
   best_iou) and the least time the card could take (`bound_ms`). best_iou
   runs fused: the three yolov3 scales as segments of one launch, timed
   as such and each scale alone, and ragged segment sets, one with NaN,
   +-inf and inverted boxes and a zero union, all held bit for bit
   against the plain version;
4. slice 1: `vit_small` at full width served by the port's own
   `serve.cli.build_server` on `cuda` — synthetic `_smoke` load, then
   `POST /predict` over 127.0.0.1 — with every answer held against
   `engine.reference()`, a small input held against the same weights on
   the CPU, and the flash-attention launch count, zeroed just before,
   showing that every dispatch went through the kernel; then
   `torch.profiler` over 5 dispatches of bucket 32 (after 3 warm-up ones)
   splits a dispatch's device time into the flash-attention kernel, GEMMs,
   copies and the rest, beside its wall time;
5. slice 2: `yolov3` at full width (416 px, 80 classes, batch 16) trained
   by the port's own `cli.run_detection` on `cuda` for 3 synthetic steps,
   2 validation batches and one checkpoint — every step's losses finite,
   the best-IoU launch count, zeroed just before, equal to 1 per train step
   and per eval batch, the checkpoint restored into a fresh trainer with
   equal weights, and the loss components of a small input held against
   the same weights on the CPU.

The line before the last is a JSON object with one record per kernel; the
last is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import copy
import functools
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from deepvision_tpu_torch.cli import run_detection
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.detection import (DetectionTrainer,
                                                 yolo_grid_sizes)
from deepvision_tpu_torch.data.detection import synthetic_batches
from deepvision_tpu_torch.models import build_model
from deepvision_tpu_torch.ops import _build
from deepvision_tpu_torch.ops import yolo as yolo_ops
from deepvision_tpu_torch.ops.attention import (flash_attention,
                                                flash_attention_reference)
from deepvision_tpu_torch.ops.best_iou import best_iou, best_iou_reference
from deepvision_tpu_torch.serve.cli import _smoke, build_parser, build_server
from deepvision_tpu_torch.serve.server import InferenceServer
from deepvision_tpu_torch.tools.build_report import (count_opcodes,
                                                     demangle, loop_report,
                                                     ptxas_by_function,
                                                     sass_by_function)
from deepvision_tpu_torch.utils.timing import graph_ms

MODEL = "vit_small"
BUCKETS = (1, 8, 32)
YOLO_MODEL = "yolov3"
YOLO_BATCH = 16
YOLO_STEPS = 3
YOLO_EVAL_BATCHES = 2          # the synthetic validation set
# best_iou against its plain version: both run the same f32 operations in
# the same order (IEEE division, no FMA contraction), so the check is bit
# for bit (NaN where the plain version has NaN); IOU_TOL, the JAX package's
# bound (tests/test_pallas_kernels.py), caps the reported max_abs_err too
IOU_TOL = 1e-6
# yolov3 loss components, card (f32 compute, best-IoU kernel, cuDNN with
# TF32 off) vs CPU (f32, plain version) on the same seeded weights, relative
# to each component: only summation orders differ, and BatchNorm in train
# mode renormalizes every layer, so the difference stays near f32 rounding
# grown over 75 conv layers
YOLO_CPU_RTOL = 1e-3
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


# -- best_iou check data: seeded boxes and the edge cases --------------------

def random_boxes(b: int, n: int, gen) -> torch.Tensor:
    """(b, n, 4) corner boxes in the unit square (some reaching past it)."""
    xy = torch.rand(b, n, 2, generator=gen) * 0.9
    wh = torch.rand(b, n, 2, generator=gen) * 0.35
    return torch.cat([xy, xy + wh], dim=-1)


def padded_gt(b: int, m: int, gen) -> torch.Tensor:
    """(b, m, 4) GT whose rows past a random count per image are zero."""
    count = torch.randint(0, m + 1, (b, 1), generator=gen)
    return random_boxes(b, m, gen) * (torch.arange(m)[None, :]
                                      < count)[..., None]


def spoil(boxes: torch.Tensor, gen,
          values=(float("nan"), float("inf"), float("-inf"))
          ) -> torch.Tensor:
    """`boxes` with some coordinates set to each of `values` and some boxes
    inverted (x2 < x1, or both axes): the plain version's IEEE semantics
    at the edges."""
    out = boxes.clone()
    n = out.shape[0] * out.shape[1]
    flat = out.view(n, 4)
    for value in values:
        rows = torch.randint(0, n, (max(1, n // 50),), generator=gen)
        cols = torch.randint(0, 4, rows.shape, generator=gen)
        flat[rows, cols] = value
    for order in ([2, 1, 0, 3], [2, 3, 0, 1]):  # x inverted; both
        rows = torch.randint(0, n, (max(1, n // 20),), generator=gen)
        flat[rows] = flat[rows][:, order]
    return out


def ragged_preds(gen) -> list:
    """Segments of 1, 130 and 507 boxes for 2 images with NaN, +-inf and
    inverted boxes, and one box of area -1e-7, whose union with a zero GT
    row is 0 (0 / 0 = NaN)."""
    preds = [spoil(random_boxes(2, n, gen), gen) for n in (1, 130, 507)]
    preds[1][1, 0] = torch.tensor([1e-7, 0.0, 0.0, 1.0])
    return preds


def ragged_gt(gen) -> torch.Tensor:
    """(2, 300, 4) padded GT, more than one shared-memory chunk, with +-inf
    coordinates and inverted boxes in both images and one NaN in image 0
    only (a NaN GT makes its image's every IoU NaN)."""
    gt = spoil(random_boxes(2, 300, gen), gen, (float("inf"), float("-inf")))
    gt[:, 250:] = 0.0
    gt[0, 7, 1] = float("nan")
    return gt


def same(out: torch.Tensor, ref: torch.Tensor) -> bool:
    """Bit for bit up to the sign of zero and NaN's payload: NaN exactly
    where `ref` has NaN, equal values elsewhere."""
    nan = torch.isnan(ref)
    return (out.shape == ref.shape and torch.equal(torch.isnan(out), nan)
            and torch.equal(out[~nan], ref[~nan]))


def abs_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |out - ref|, 0 where both are equal (the same +-inf
    included) or both NaN; NaN where only one of them is NaN."""
    agree = (out == ref) | (torch.isnan(out) & torch.isnan(ref))
    return torch.where(agree, 0.0, (out - ref).abs()).max().item()


def phase(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 50) -> float:
    """Mean time of one call of `fn` over a host loop of `iters` calls,
    between CUDA events: where the device outruns the host, this reads the
    host's dispatch cost (Python, wrapper, launch), not the device's."""
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


# the bf16 flash-attention kernels, (DMAX, 16-byte copies), as their
# Itanium-mangled template arguments spell them
TC_KERNELS = {(dmax, vec): f"flash_attention_fwd_tcILi{dmax}ELb{int(vec)}EE"
              for dmax in (64, 128) for vec in (True, False)}


def check_tensor_cores(hmma: dict) -> None:
    """Fails unless the SASS's {mangled kernel: HMMA count} lists every
    bf16 flash-attention kernel once, each with tensor-core instructions."""
    for key, tag in TC_KERNELS.items():
        counts = [n for raw, n in hmma.items() if tag in raw]
        if len(counts) != 1 or counts[0] < 1:
            raise AssertionError(
                f"bf16 flash-attention kernel (DMAX, 16-byte) {key}: HMMA "
                f"counts in the SASS {counts}, want one kernel with at "
                f"least one")


def report_build(names) -> dict:
    """Per kernel function: ptxas's resources and the SASS's HMMA count
    (the bf16 attention kernels must use the tensor cores); for best_iou
    also its SASS counts (`sass_counts`). Returns those counts."""
    k2 = {}
    for lib in names:
        ptxas = ptxas_by_function(_build.BUILD_INFO.get(lib, {})
                                  .get("ptxas", ""))
        sass = sass_by_function(str(_build._target(lib)))
        hmma = {raw: count_opcodes(instrs, r"H(G)?MMA\b")
                for raw, instrs in sass.items()}
        mangled = sorted(set(ptxas) | set(hmma))
        for raw, name in zip(mangled, demangle(mangled)):
            phase(f"{lib}: {name}: {ptxas.get(raw, 'cached build')}; "
                  f"HMMA in SASS: {hmma.get(raw, 'not found')}")
        if lib == "flash_attention":
            check_tensor_cores(hmma)
        if lib == "best_iou":
            k2 = sass_counts(sass)
            phase(f"best_iou SASS: {json.dumps(k2)}")
    return k2


def sass_counts(sass: dict) -> dict:
    """The best-IoU kernel's SASS: its instructions, divisions (MUFU.RCP,
    one per pair) and NaN-propagating min/max (FMNMX), and its innermost
    loop with the most divisions (the unrolled pairs): that loop's length
    per pair is what one (n, m) pair costs in issue slots, against the 16
    operations of the bound."""
    raw = [k for k in sass if "best_iou" in k]
    if len(raw) != 1:
        raise AssertionError(f"best_iou kernels in the SASS: {raw}")
    instrs = sass[raw[0]]
    loop = loop_report(instrs, "MUFU.RCP")
    return {"instructions": len(instrs),
            "MUFU.RCP": count_opcodes(instrs, r"MUFU\.RCP"),
            "FMNMX": count_opcodes(instrs, r"FMNMX"),
            "loop": loop,
            "loop_instructions_per_pair": (
                loop["instructions"] / loop["MUFU.RCP"] if loop else None)}


def attention_bound(shape, dtype):
    """Least time for softmax(QK^T)V on `shape`: Q, K, V read once and O
    written once, against 2 products of 2*B*H*N*N*D operations."""
    b, h, n, d = shape
    nbytes = 4 * b * h * n * d * torch.finfo(dtype).bits // 8
    flops = 4 * b * h * n * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_qkv(shape, dtype, gen, layout: str = "contiguous"):
    """q, k, v of (B, H, N, D) on the card: `contiguous`; `strided`, the
    model's (B, N, H*D) projections viewed as (B, H, N, D); `offset_1`,
    rows off 16 bytes (the kernel's scalar-copy variant)."""
    b, h, n, d = shape
    if layout == "strided":
        return [torch.randn((b, n, h * d), generator=gen).to("cuda", dtype)
                .view(b, n, h, d).permute(0, 2, 1, 3) for _ in range(3)]
    if layout == "offset_1":
        return [torch.randn(b * h * n * d + 1, generator=gen)
                .to("cuda", dtype)[1:].view(shape) for _ in range(3)]
    return [torch.randn(shape, generator=gen).to("cuda", dtype)
            for _ in range(3)]


def check_attention(shape, dtype, gen, timed: bool,
                    layout: str = "contiguous") -> dict:
    q, k, v = make_qkv(shape, dtype, gen, layout)
    out = flash_attention(q, k, v)
    ref = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    if out.shape != q.shape or out.dtype != dtype:
        raise AssertionError(f"flash_attention gave {tuple(out.shape)} "
                             f"{out.dtype} for {tuple(shape)} {dtype}")
    err = (out.float() - ref.float()).abs().max().item()
    rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "layout": layout, "max_abs_err": err}
    line = (f"flash_attention {rec['dtype']} {tuple(shape)} {layout}: "
            f"max_abs_err={err:.3g}")
    if err > TOL[dtype] or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{line} exceeds {TOL[dtype]:g}")
    if timed:
        bound, bound_by = attention_bound(shape, dtype)
        kernel = functools.partial(flash_attention, q, k, v)
        library = functools.partial(F.scaled_dot_product_attention, q, k, v)
        rec.update(
            ms=time_ms(kernel), device_ms=graph_ms(kernel),
            plain_ms=time_ms(lambda: flash_attention_reference(q, k, v), 10),
            library_ms=time_ms(library), library_device_ms=graph_ms(library),
            bound_ms=bound, bound_by=bound_by)
        line += (f" ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f} "
                 f"plain_ms={rec['plain_ms']:.4f} "
                 f"library_ms={rec['library_ms']:.4f} "
                 f"library_device_ms={rec['library_device_ms']:.4f} "
                 f"bound_ms={bound:.5f} ({bound_by}) "
                 f"device_ms/bound={rec['device_ms'] / bound:.2f} "
                 f"device_ms/library_device_ms="
                 f"{rec['device_ms'] / rec['library_device_ms']:.2f}")
    phase(line)
    return rec


def best_iou_bound(b: int, n: int, m: int):
    """Least time for best_iou at (b, n, 4) x (b, m, 4), n the predicted
    boxes of all segments: predictions and GT read once and the (b, n)
    output written once, against 16 f32 operations per (n, m) pair
    (csrc/best_iou.cu) at the f32 peak of the CUDA cores."""
    t_bytes = (b * n * 16 + b * m * 16 + b * n * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 16 * b * n * m / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_best_iou(preds, gt, timed: bool) -> dict:
    """best_iou of `preds` (one (B, N, 4) tensor or a list of segments)
    against `gt` on the card, one launch, held bit for bit against the
    plain version; with `timed`, its times beside the bound."""
    single = isinstance(preds, torch.Tensor)
    preds = [p.cuda() for p in ([preds] if single else preds)]
    gt = gt.cuda()
    arg = preds[0] if single else preds
    before = best_iou.launches
    outs = best_iou(arg, gt)
    launched = best_iou.launches - before
    outs = [outs] if single else outs
    refs = best_iou_reference(preds, gt)
    torch.cuda.synchronize()
    b, m = gt.shape[0], gt.shape[1]
    segments = [[b, p.shape[1], m] for p in preds]
    for out, p in zip(outs, preds):
        if out.shape != p.shape[:2] or out.dtype != torch.float32:
            raise AssertionError(f"best_iou gave {tuple(out.shape)} "
                                 f"{out.dtype} for {tuple(p.shape)}")
    err = max(abs_err(o, r) for o, r in zip(outs, refs))
    exact = all(same(o, r) for o, r in zip(outs, refs))
    n = sum(p.shape[1] for p in preds)
    rec = {"shape": [b, n, m], "segments": segments, "max_abs_err": err}
    line = (f"best_iou {'single' if single else 'fused'} "
            f"{[s[1] for s in segments]} of B={b}, M={m}: launches="
            f"{launched} max_abs_err={err:.3g} bit_for_bit={exact}")
    if launched != 1 or not err <= IOU_TOL or not exact:
        raise AssertionError(f"{line}: want 1 launch, equal to the plain "
                             f"version")
    if timed:
        bound, bound_by = best_iou_bound(b, n, m)
        kernel = functools.partial(best_iou, arg, gt)
        rec.update(ms=time_ms(kernel), device_ms=graph_ms(kernel),
                   plain_ms=time_ms(lambda: best_iou_reference(arg, gt), 10),
                   library_ms=None, library_device_ms=None, bound_ms=bound,
                   bound_by=bound_by)
        line += (f" ms={rec['ms']:.4f} device_ms={rec['device_ms']:.5f} "
                 f"plain_ms={rec['plain_ms']:.4f} "
                 f"bound_ms={bound:.5f} ({bound_by}) device_ms/bound="
                 f"{rec['device_ms'] / bound:.2f}")
    phase(line)
    return rec


def yolo_loss_components(model, batch, device) -> dict:
    """Per-image yolov3 loss components of `batch` through a copy of
    `model` on `device`, BatchNorm in train mode, no update."""
    m = copy.deepcopy(model).to(device).train()
    images, boxes, classes, valid = (torch.from_numpy(a).to(device)
                                     for a in batch)
    c = m.num_classes
    onehot = (classes.long()[..., None]
              == torch.arange(c, device=device)).float()
    grids = yolo_grid_sizes(images.shape[1])
    with torch.no_grad():
        y_trues = yolo_ops.encode_labels(onehot, boxes, valid, grids)
        comp = yolo_ops.yolo_loss(y_trues, m(images), boxes, valid, c)
    return {k: v.cpu() for k, v in comp.items()}


def check_yolo_slice() -> dict:
    """Slice 2: yolov3 training through the port's own entry point."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_yolo_")
    try:
        torch.cuda.reset_peak_memory_stats()
        best_iou.launches = 0            # counts of the main path only
        t0 = time.perf_counter()
        trainer, result = run_detection("YOLO", [YOLO_MODEL], [
            "-m", YOLO_MODEL, "--synthetic", "--image-size", "416",
            "--batch-size", str(YOLO_BATCH), "--steps-per-epoch",
            str(YOLO_STEPS), "--epochs", "1", "--device", "cuda",
            "--workdir", workdir])
        wall = time.perf_counter() - t0
        launches = best_iou.launches
        peak = torch.cuda.max_memory_allocated()
        cfg = trainer.config
        if (cfg.data.image_size, cfg.data.num_classes, cfg.batch_size) != (
                416, 80, YOLO_BATCH):
            raise AssertionError(f"yolov3 ran at {cfg.data}")
        steps = trainer.last_epoch_steps
        for i, s in enumerate(steps):
            phase(f"yolov3 step {i + 1}: " + " ".join(
                f"{k}={v:.4f}" for k, v in s.items()))
        if len(steps) != YOLO_STEPS or not all(
                np.isfinite(v) for s in steps for v in s.values()):
            raise AssertionError(f"yolov3 steps not all finite: {steps}")
        val_loss = result.get("loss", float("nan"))
        if result.get("count") != YOLO_EVAL_BATCHES or not np.isfinite(
                val_loss):
            raise AssertionError(f"yolov3 validation: {result}")
        dispatches = YOLO_STEPS + YOLO_EVAL_BATCHES
        phase(f"main path: {YOLO_STEPS} train steps + {YOLO_EVAL_BATCHES} "
              f"eval batches, {launches} best_iou launches; val_loss="
              f"{val_loss:.4f}; run_detection {wall:.1f}s")
        if launches != dispatches:
            raise AssertionError(f"best_iou ran {launches} times for "
                                 f"{dispatches} dispatches, want one each "
                                 f"(all 3 scales in one launch)")
        step_ms = statistics.median(s["step_ms"] for s in steps[1:])
        phase(f"yolov3 train step (batch {YOLO_BATCH}, 416 px, bf16): "
              f"step_ms={step_ms:.3f} (median after the first; first "
              f"{steps[0]['step_ms']:.3f}) images_per_sec="
              f"{YOLO_BATCH / step_ms * 1e3:.2f} peak_memory_allocated="
              f"{peak / 2**30:.3f} GiB")

        fresh = DetectionTrainer(cfg, device="cuda", workdir=workdir)
        fresh.init_state()
        if fresh.resume() != 1:
            raise AssertionError("the epoch-1 checkpoint did not restore")
        want, got = trainer.state.state_dict(), fresh.state.state_dict()
        same = (all(torch.equal(v, got["model"][k])
                    for k, v in want["model"].items())
                and want["step"] == got["step"]
                and want["optimizer"]["count"] == got["optimizer"]["count"])
        fresh.close()
        phase(f"checkpoint round trip: {len(want['model'])} tensors, step "
              f"{got['step']}, equal={same}")
        if not same:
            raise AssertionError("restored weights differ from the trained")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    model = build_model(get_config(YOLO_MODEL).replace(dtype="float32"))
    batch = next(synthetic_batches(batch_size=2, image_size=416,
                                   num_classes=80, steps=1, seed=7))
    card = yolo_loss_components(model, batch, torch.device("cuda"))
    cpu = yolo_loss_components(model, batch, torch.device("cpu"))
    rel = max(((card[k] - cpu[k]).abs() / cpu[k].abs().clamp(min=1.0))
              .max().item() for k in cpu)
    phase(f"yolov3 card vs CPU plain path, f32, 2 images at 416 px: loss "
          f"components {', '.join(f'{k}={cpu[k].tolist()}' for k in cpu)}; "
          f"max relative difference {rel:.3g} (bound {YOLO_CPU_RTOL:g})")
    if not all(torch.isfinite(v).all() for v in cpu.values()) \
            or rel > YOLO_CPU_RTOL:
        raise AssertionError(f"card and CPU loss differ by {rel:g}")
    return {"launches": launches, "step_ms": step_ms}


GEMM_KEYS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")


def profile_dispatches(engine, bucket: int, warmup: int = 3,
                       iters: int = 5) -> dict:
    """Device ms per dispatch of `bucket` by kernel family, from
    `torch.profiler` over `iters` `engine.predict` calls after `warmup`
    ones, beside the wall ms per dispatch (host clock, synchronized)."""
    x = np.random.RandomState(2).randn(
        bucket, *engine.example_shape).astype(np.float32)
    for _ in range(warmup):
        engine.predict(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.predict(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    fam = {"flash_attention": 0.0, "gemm": 0.0, "copy": 0.0, "rest": 0.0}
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / iters
        low = e.name.lower()
        key = ("flash_attention" if "flash_attention" in low
               else "gemm" if any(g in low for g in GEMM_KEYS)
               else "copy" if "memcpy" in low or "memset" in low
               else "rest")
        fam[key] += ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    busy = sum(fam.values())
    if busy <= 0 or fam["flash_attention"] <= 0:
        raise AssertionError(f"the profile holds no device time for the "
                             f"attention kernel: {fam}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "busy_ms": busy, "family_ms": fam,
            "top": [(name[:90], ms) for name, ms in top]}


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
    libraries = ["flash_attention", "best_iou"]
    _build.build(libraries)
    phase(f"kernels built in {time.perf_counter() - t0:.1f}s")
    for name, info in _build.BUILD_INFO.items():
        phase(f"{name}: nvcc {info['seconds']:.1f}s")
    k2_sass = report_build(libraries)

    # 3. kernel against its plain version on the card
    gen = torch.Generator().manual_seed(0)
    cfg = get_config(MODEL)
    heads = cfg.model_kwargs["num_heads"]
    d = cfg.model_kwargs["embed_dim"] // heads
    n = (cfg.data.image_size // cfg.model_kwargs["patch_size"]) ** 2 + 1
    main_path = [check_attention((b, heads, n, d), torch.bfloat16, gen, True,
                                 layout)
                 for b in BUCKETS for layout in ("contiguous", "strided")]
    ragged = [check_attention((2, heads, nr, d), dt, gen, False)
              for nr in (1, 5, 17, 65, 300)
              for dt in (torch.float32, torch.bfloat16)]
    ragged += [check_attention((2, 3, 77, dr), torch.bfloat16, gen, False)
               for dr in (8, 40, 128)]
    ragged += [check_attention((2, 3, 33, 64), torch.bfloat16, gen, False,
                               "offset_1"),
               check_attention((2, 3, 33, 12), torch.bfloat16, gen, False)]
    max_err = max(r["max_abs_err"] for r in main_path + ragged)
    # best_iou at the three yolov3 scales (416 px, batch 16, MAX_BOXES GT):
    # fused in one launch as the loss calls it, then each scale alone (the
    # earlier per-scale rows); ragged segment sets (one box; 3 GT; one GT;
    # more GT than one shared-memory chunk; NaN, +-inf and inverted boxes;
    # batch 1)
    ns = [3 * g * g for g in yolo_grid_sizes(416)]
    preds = [random_boxes(YOLO_BATCH, n, gen) for n in ns]
    gt = padded_gt(YOLO_BATCH, yolo_ops.MAX_BOXES, gen)
    iou_fused = check_best_iou(preds, gt, True)
    iou_scales = [check_best_iou(p, gt, True) for p in preds]
    iou_ragged = [check_best_iou([random_boxes(b, n, gen) for n in segs],
                                 padded_gt(b, m, gen), False)
                  for b, segs, m in (
                      (16, (1, 130, 507), 100), (16, (1, 130, 507), 3),
                      (2, (507, 1, 130), 1), (2, (130, 1, 507), 300),
                      (1, (8112, 2028, 507), 100))]
    iou_ragged.append(check_best_iou(ragged_preds(gen), ragged_gt(gen),
                                     False))
    iou_err = max(r["max_abs_err"]
                  for r in [iou_fused] + iou_scales + iou_ragged)

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
    prof = profile_dispatches(engine, BUCKETS[-1])
    fam = prof["family_ms"]
    phase(f"profile, bucket {BUCKETS[-1]}, device ms per dispatch: "
          + " ".join(f"{k}={v:.4f}" for k, v in fam.items())
          + f"; busy {prof['busy_ms']:.4f} of wall {prof['wall_ms']:.4f} "
          f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}% busy); "
          f"flash_attention {100 * fam['flash_attention'] / prof['busy_ms']:.2f}"
          f"% of device time")
    for name, ms in prof["top"]:
        phase(f"profile top kernel: {ms:.4f} ms/dispatch {name}")

    # 5. slice 2: yolov3 training
    yolo = check_yolo_slice()
    k2_ms = iou_fused["device_ms"]
    phase(f"where a yolov3 train step goes: best_iou {k2_ms:.5f} ms of "
          f"{yolo['step_ms']:.3f} ms ({100 * k2_ms / yolo['step_ms']:.4f}%, "
          f"one fused launch, its device time from phase 3)")

    timed_keys = ("shape", "layout", "ms", "device_ms", "plain_ms",
                  "library_ms", "library_device_ms", "bound_ms")
    b32 = main_path[-1]                  # bucket 32, the model's layout
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "deepvision_tpu_torch/csrc/flash_attention.cu",
        "replaces": "deepvision_tpu/ops/attention.py:73",
        "launches": launches, "max_abs_err": max_err,
        "ms": b32["ms"], "device_ms": b32["device_ms"],
        "plain_ms": b32["plain_ms"], "bound_ms": b32["bound_ms"],
        "bound_by": b32["bound_by"], "library_ms": b32["library_ms"],
        "library_device_ms": b32["library_device_ms"],
        "shape": b32["shape"], "layout": b32["layout"], "dtype": b32["dtype"],
        "dispatch_profile": prof,
        "shapes": [{k: r[k] for k in timed_keys} for r in main_path]}, {
        "name": "best_iou", "route": "cuda",
        "source": "deepvision_tpu_torch/csrc/best_iou.cu",
        "replaces": "deepvision_tpu/ops/pallas_kernels.py:33",
        "launches": yolo["launches"], "max_abs_err": iou_err,
        "ms": iou_fused["ms"], "device_ms": iou_fused["device_ms"],
        "plain_ms": iou_fused["plain_ms"], "bound_ms": iou_fused["bound_ms"],
        "bound_by": iou_fused["bound_by"], "library_ms": None,
        "library_device_ms": None, "shape": iou_fused["shape"],
        "segments": iou_fused["segments"], "dtype": "float32",
        "sass": k2_sass,
        "scales": [{k: r[k] for k in ("shape", "ms", "device_ms", "plain_ms",
                                      "bound_ms")}
                   for r in iou_scales]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
