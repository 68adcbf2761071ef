"""Pixel helpers shared by the port's input pipelines (own copy of
deepvision_tpu/data/util.py, plus the resizes the JAX pipelines take from
TensorFlow and PIL).

The resizes are weight matrices, one per axis, applied as two products:
- `bicubic`: `tf.image.resize(method="bicubic")` (no antialias): Keys'
  cubic with a = -0.5, half-pixel centres, the fractional offset rounded
  to TensorFlow's 1/1024 weight table, taps outside the image dropped and
  each row's weights renormalised to sum to 1;
- `bilinear`: `tf.image.resize`'s default (half-pixel, no antialias),
  which is also `F.interpolate(mode="bilinear", align_corners=False)`;
- `bilinear_aa`: PIL's `BILINEAR` resize (`data/transforms.py`), a
  triangle filter widened by the scale when shrinking, as
  `F.interpolate(mode="bilinear", antialias=True)` computes it.

The weights are computed in float32 step by step as TensorFlow and PIL do,
so `csrc/jpeg_decode.cu`'s fused resample kernel (compiled without FMA
contraction) computes the same weights; `resample` here is its plain
version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

MODES = ("bicubic", "bilinear", "bilinear_aa")
MODE_IDS = {m: i for i, m in enumerate(MODES)}
TABLE_SIZE = 1024   # TensorFlow's bicubic weight table
CUBIC_A = np.float32(-0.5)


def to_uint8_pixels(image: torch.Tensor) -> torch.Tensor:
    """Raw uint8 pixels for device-side normalisation (`--device-
    normalize`): clip to [0, 255], round half to even (`tf.round`), cast."""
    return torch.round(image.clamp(0.0, 255.0)).to(torch.uint8)


def _cubic_table(offset: np.ndarray) -> Tuple[np.ndarray, ...]:
    """TensorFlow's Keys table entries for integer offsets in [0, 1024]:
    (weight at 1 + x, weight at x, weight at 1 - x, weight at 2 - x)."""
    f32 = np.float32
    a = CUBIC_A

    def near(i):      # |t| <= 1: ((a + 2) t - (a + 3)) t t + 1
        x = (i.astype(f32) / f32(TABLE_SIZE)).astype(f32)
        return ((a + f32(2)) * x - (a + f32(3))) * x * x + f32(1)

    def far(i):       # 1 < |t| < 2: ((a t - 5a) t + 8a) t - 4a
        x = (i.astype(f32) / f32(TABLE_SIZE)).astype(f32) + f32(1)
        return ((a * x - f32(5) * a) * x + f32(8) * a) * x - f32(4) * a

    return (far(offset), near(offset), near(TABLE_SIZE - offset),
            far(TABLE_SIZE - offset))


@functools.lru_cache(maxsize=4096)
def resize_weights(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """(out_size, in_size) float32: row o holds the weights that output
    pixel o gives the input pixels, for one axis."""
    f32 = np.float32
    w = np.zeros((out_size, in_size), np.float32)
    o = np.arange(out_size)
    rows = np.arange(out_size)
    if mode in ("bicubic", "bilinear"):
        scale = f32(in_size) / f32(out_size)
        loc = (o.astype(f32) + f32(0.5)) * scale - f32(0.5)
        if mode == "bilinear":
            loc = np.maximum(loc, f32(0))
            i0 = np.floor(loc).astype(np.int64)
            lerp = (loc - i0.astype(f32)).astype(f32)
            i1 = np.minimum(i0 + 1, in_size - 1)
            np.add.at(w, (rows, i0), f32(1) - lerp)
            np.add.at(w, (rows, i1), lerp)
            return w
        base = np.floor(loc).astype(np.int64)
        delta = (loc - base.astype(f32)).astype(f32)
        offset = np.rint(delta * f32(TABLE_SIZE)).astype(np.int64)
        taps = _cubic_table(offset)
        total = np.zeros(out_size, np.float32)
        keep = []
        for k, wt in zip(range(-1, 3), taps):
            idx = base + k
            ok = (idx >= 0) & (idx < in_size)
            wt = np.where(ok, wt, f32(0)).astype(f32)
            total = (total + wt).astype(f32)
            keep.append((np.clip(idx, 0, in_size - 1), wt))
        inv = (f32(1) / total).astype(f32)
        for idx, wt in keep:
            np.add.at(w, (rows, idx), (wt * inv).astype(f32))
        return w
    if mode == "bilinear_aa":
        scale = f32(in_size) / f32(out_size)
        support = scale if scale >= 1 else f32(1)
        inv = f32(1) / scale if scale >= 1 else f32(1)
        for i in range(out_size):
            center = scale * (f32(i) + f32(0.5))
            lo = max(int(center - support + f32(0.5)), 0)
            hi = min(int(center + support + f32(0.5)), in_size)
            j = np.arange(lo, hi)
            t = np.abs((j.astype(f32) - center + f32(0.5)) * inv)
            wt = np.where(t < 1, f32(1) - t, f32(0)).astype(f32)
            tot = wt.sum(dtype=np.float32)
            w[i, lo:hi] = wt / tot if tot != 0 else wt
        return w
    raise ValueError(f"unknown resize mode {mode!r} (one of {MODES})")


class Plan(NamedTuple):
    """One image's geometry: the `crop` (y, x, h, w) of the decoded image
    is resized to `size` (RH, RW); `flip` mirrors the resized image left
    to right; the output is its `window` (oy, ox) of the batch's output
    size. Every pipeline's crop → flip → resize → crop chain maps onto it
    (a flip before the resize mirrors the crop's x and flips after it:
    the half-pixel resizes commute with a mirror)."""
    crop: Tuple[int, int, int, int]
    size: Tuple[int, int]
    window: Tuple[int, int] = (0, 0)
    flip: bool = False


class Emit(NamedTuple):
    """What a resampled pixel v becomes: `uint8` rounds half to even
    after clipping to [0, 255]; otherwise float32 `(v / div - mean) /
    std`, after clipping when `clip`."""
    uint8: bool
    clip: bool = True
    div: float = 255.0
    mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    std: Tuple[float, float, float] = (1.0, 1.0, 1.0)


UINT8 = Emit(uint8=True)


def unit_range() -> Emit:
    """`image / 127.5 - 1` unclipped: detection, pose, CycleGAN."""
    return Emit(uint8=False, clip=False, div=127.5, mean=(1.0, 1.0, 1.0))


def normalized(mean: Sequence[float], std: Sequence[float]) -> Emit:
    """ImageNet's host normalisation: clip, `/255`, `(x - mean) / std`."""
    return Emit(uint8=False, clip=True, div=255.0,
                mean=tuple(float(m) for m in mean),
                std=tuple(float(s) for s in std))


def emit(values: torch.Tensor, how: Emit) -> torch.Tensor:
    """Apply `how` to resampled float32 pixels (..., 3)."""
    if how.uint8:
        return to_uint8_pixels(values)
    if how.clip:
        values = values.clamp(0.0, 255.0)
    mean = torch.tensor(how.mean, dtype=torch.float32, device=values.device)
    std = torch.tensor(how.std, dtype=torch.float32, device=values.device)
    return (values / how.div - mean) / std


def plan_weights(plan: Plan, out_hw: Tuple[int, int], mode: str
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The (out_h, crop_h) and (out_w, crop_w) weights of `plan`."""
    _, _, ch, cw = plan.crop
    rh, rw = plan.size
    oy, ox = plan.window
    wy = resize_weights(ch, rh, mode)[oy:oy + out_hw[0]]
    wx = resize_weights(cw, rw, mode)
    if plan.flip:
        wx = wx[::-1]
    wx = wx[ox:ox + out_hw[1]]
    if wy.shape[0] != out_hw[0] or wx.shape[0] != out_hw[1]:
        raise ValueError(f"window {plan.window} of a {plan.size} resize "
                         f"does not hold {out_hw}")
    return wy, wx


def resample_one(image: torch.Tensor, plan: Plan, out_hw: Tuple[int, int],
                 mode: str) -> torch.Tensor:
    """The plain version of the resample kernel for one HWC image
    (uint8 or float): crop, resize, flip, window, in float32."""
    y, x, ch, cw = plan.crop
    img = image[y:y + ch, x:x + cw].to(torch.float32)
    wy, wx = plan_weights(plan, out_hw, mode)
    wy = torch.from_numpy(np.ascontiguousarray(wy)).to(img.device)
    wx = torch.from_numpy(np.ascontiguousarray(wx)).to(img.device)
    rows = torch.einsum("xw,hwc->hxc", wx, img)
    return torch.einsum("yh,hxc->yxc", wy, rows)


def resample(images: Sequence[torch.Tensor], plans: Sequence[Plan],
             out_hw: Tuple[int, int], mode: str, how: Emit) -> torch.Tensor:
    """A (B, H, W, 3) batch from decoded HWC images, each through its
    plan, emitted as `how` says (the plain version of
    `jpeg.resample_batch`'s kernel)."""
    out = torch.stack([resample_one(im, p, out_hw, mode)
                       for im, p in zip(images, plans)])
    return emit(out, how)


def resize_image(image: torch.Tensor, out_hw: Tuple[int, int],
                 mode: str) -> torch.Tensor:
    """A whole HWC image resized to `out_hw`, float32 (tests, helpers)."""
    h, w = image.shape[:2]
    return resample_one(image, Plan((0, 0, h, w), tuple(out_hw)), out_hw,
                        mode)
