"""Where a train step's device time goes, by kernel family.

`profile_steps` runs warm-up steps, then traces steps with `torch.profiler`
and sums each device kernel's own duration into the first family of
`FAMILIES` whose fragment its name contains (casts are the `direct_copy`
kernels; BatchNorm's separate `var_mean` pass for the running statistics,
a Welford reduction, is `bn_var_mean`). Kernels launched inside one of the
host ranges of `RANGES` are also counted apart, split by the same
families: the backward of the flash-attention operator (the naive VJP,
which the autograd engine runs inside a range named after the node that
`register_autograd` generates), the EMA update and the device augmentation (the trainer's and the
step's `record_function` ranges). `print_report` prints a step's split,
the device's busy and idle share of the wall time, and the kernels with
the most device time. Under a process group (a torchrun launch) the
collectives' kernels are the `nccl` family, and `run_tag` names the
world.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from ..parallel import mesh

# kernel-name fragments, checked in order; the first match names the family
FAMILIES = (
    ("nccl", ("nccl",)),
    ("flash_attention", ("flash_attention",)),
    ("best_iou", ("best_iou",)),
    ("optimizer", ("adam", "multi_tensor_apply", "sgd")),
    ("layer_norm", ("layer_norm", "layernorm", "gammabeta")),
    ("bn_var_mean", ("welford",)),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("softmax", ("softmax",)),
    ("conv_gemm", ("conv", "cudnn", "gemm", "xmma", "sm90", "nvjet",
                   "implicit", "wgrad", "dgrad", "cutlass", "nchwtonhwc",
                   "nhwctonchw")),
    ("reduce", ("reduce",)),
    ("cast", ("direct_copy", "bfloat16_copy")),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index",
                     "scatter", "gather", "cat", "upsample", "pad")),
)
#: host ranges whose kernels are counted apart: the autograd engine's
#: range around the attention backward, the trainer's around the EMA
#: update, the train step's around the device augmentation
RANGES = {"attention_backward":   # the node's, not its forward's range
          "GeneratedBackwardFor_deepvision_flash_attention_defaultBackward",
          "ema": "ema_update", "augment": "device_augment"}


def run_tag() -> str:
    """", under DDP at world N (backend)" when a process group is up (the
    script ran under torchrun), else ""."""
    if not mesh.is_initialized():
        return ""
    return (f", under DDP at world {mesh.world_size()} "
            f"({torch.distributed.get_backend()})")


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _under(event, fragment: str) -> bool:
    while event is not None:
        if fragment in event.name:
            return True
        event = event.cpu_parent
    return False


def profile_steps(run_step: Callable[[int], object], warmup: int,
                  steps: int) -> Dict[str, object]:
    """`run_step(i)` for i < warmup, then `steps` more under the profiler.
    Per step: `wall_ms` (host clock, synchronized, profiler included),
    `busy_ms` (device kernels), `family_ms`, `ranges_ms` (per range of
    `RANGES`, by family, also counted in `family_ms`' totals), `kernels`,
    and `top`, the 15 kernels with the most device time."""
    for i in range(warmup):
        run_step(i)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(warmup, warmup + steps):
            run_step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.events()
    totals: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    n_kernels = 0
    for e in events:
        # a range of record_function on the device's timeline (the
        # optimizer's `Optimizer.step#...`, the EMA's) spans kernels
        # counted anyway
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = e.time_range.elapsed_us()      # the kernel's own duration
        totals[family(e.name)] = totals.get(family(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        n_kernels += 1
    ranges: Dict[str, Dict[str, float]] = {name: {} for name in RANGES}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        for name, fragment in RANGES.items():
            if _under(e, fragment):
                for k in e.kernels:
                    fam = family(k.name)
                    ranges[name][fam] = ranges[name].get(fam, 0.0) + k.duration
                break
    per_step = 1e3 * steps
    return {"wall_ms": wall_ms,
            "busy_ms": sum(totals.values()) / per_step,
            "family_ms": {k: v / per_step for k, v in totals.items()},
            "ranges_ms": {name: {k: v / per_step for k, v in fams.items()}
                          for name, fams in ranges.items()},
            "kernels": n_kernels / steps,
            "top": [(name, us / per_step) for name, us in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:15]]}


def print_report(title: str, stats: Dict[str, object]) -> None:
    """The split of one step: family by family (each range of `RANGES`
    apart from the rest), then the top kernels."""
    wall, busy = stats["wall_ms"], stats["busy_ms"]
    ranges = {name: fams for name, fams in stats["ranges_ms"].items() if fams}
    print(f"{title}: wall {wall:.3f} ms/step (profiled), device busy "
          f"{busy:.3f} ms/step ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%; {stats['kernels']:.0f} "
          f"kernels/step", flush=True)
    rest = dict(stats["family_ms"])
    for name, fams in ranges.items():
        for fam, ms in fams.items():
            rest[fam] -= ms
        rest[name] = sum(fams.values())
    for fam, ms in sorted(rest.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:18s} {ms:9.3f} ms/step  {100 * ms / busy:5.1f}% of "
              f"device time", flush=True)
    for name, fams in ranges.items():
        for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
            print(f"    {name}/{fam:12s} {ms:9.3f} ms/step", flush=True)
    print("top kernels (ms/step):", flush=True)
    for name, ms in stats["top"]:
        print(f"  {ms:9.3f}  [{family(name)}] {name[:110]}", flush=True)
