"""Best IoU of each predicted box against the ground truth — the YOLO
ignore mask's hot spot: out[b, n] = max_m IoU(pred[b, n], gt[b, m]).

Port of deepvision_tpu/ops/pallas_kernels.py, named after what it
computes. Two versions of one function:

- `best_iou_reference`: the plain PyTorch version — `broadcast_iou` and a
  max over M, one tile of `BLOCK_N` predicted boxes at a time, as the TPU
  kernel tiles N, so only a (B, BLOCK_N, M) intermediate ever exists.
- `best_iou`: the wrapper of the hand-written CUDA kernel
  (csrc/best_iou.cu, which replaces the Pallas kernel
  deepvision_tpu/ops/pallas_kernels.py:33). A CUDA tensor launches the
  kernel or raises; only a CPU tensor takes the plain version. There is no
  fallback and no switch that takes the kernel off the path.

Both work on detached inputs: the YOLO loss consumes the result through a
`<` (the JAX package wraps it in stop_gradient), so it has no gradient.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ._build import load_library
from .boxes import broadcast_iou

#: predicted boxes per tile of the plain version: the TPU kernel's block_n
BLOCK_N = 512
#: dtypes the wrapper takes; both go to the kernel as f32, as the JAX
#: package casts to f32 (pallas_kernels.py:79-80)
_DTYPES = (torch.float32, torch.float64)


def best_iou_reference(pred_boxes: torch.Tensor,
                       gt_boxes: torch.Tensor) -> torch.Tensor:
    """max_m IoU(pred_n, gt_m): (B, N, 4) x (B, M, 4) corner boxes → (B, N)
    f32, in tiles of BLOCK_N predicted boxes."""
    pred = pred_boxes.detach().float()
    gt = gt_boxes.detach().float()
    b, n, _ = pred.shape
    out = torch.empty((b, n), dtype=torch.float32, device=pred.device)
    for n0 in range(0, n, BLOCK_N):
        out[:, n0:n0 + BLOCK_N] = broadcast_iou(
            pred[:, n0:n0 + BLOCK_N], gt).amax(dim=-1)
    return out


def _check(pred: torch.Tensor, gt: torch.Tensor) -> None:
    """What the kernel takes: (B, N, 4) and (B, M, 4) on one device, N, M,
    B >= 1, f32 (or f64, cast to f32)."""
    for name, t in (("pred_boxes", pred), ("gt_boxes", gt)):
        if t.dim() != 3 or t.shape[-1] != 4:
            raise ValueError(f"{name} must be (B, N, 4), got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} dtype {t.dtype} unsupported (float32, "
                            f"or float64 cast to float32)")
        if min(t.shape) < 1:
            raise ValueError(f"empty {name} {tuple(t.shape)}")
    if pred.shape[0] != gt.shape[0]:
        raise ValueError(f"batch sizes differ: {pred.shape[0]} predicted, "
                         f"{gt.shape[0]} ground truth")
    if pred.device != gt.device:
        raise ValueError(f"pred_boxes on {pred.device}, gt_boxes on "
                         f"{gt.device}")


_launches_lock = threading.Lock()


@functools.cache
def _kernel():
    fn = load_library("best_iou").dv_best_iou
    # pointers and the stream as c_void_p: untyped, ctypes would pass them
    # as 32-bit ints and cut them
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def best_iou(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """max_m IoU(pred_n, gt_m): (B, N, 4) x (B, M, 4) corner boxes → (B, N)
    f32. Padded GT rows must be zeroed by the caller (zero area → IoU 0).

    On a CUDA tensor this launches the kernel on the current stream and
    counts the launch in `best_iou.launches`. On a CPU tensor it returns
    `best_iou_reference`. Any other device raises."""
    _check(pred_boxes, gt_boxes)
    if pred_boxes.device.type == "cpu":
        return best_iou_reference(pred_boxes, gt_boxes)
    if pred_boxes.device.type != "cuda":
        raise ValueError(f"best_iou runs on cuda or cpu, got "
                         f"{pred_boxes.device}")
    pred = pred_boxes.detach().float().contiguous()
    gt = gt_boxes.detach().float().contiguous()
    b, n, _ = pred.shape
    out = torch.empty((b, n), dtype=torch.float32, device=pred.device)
    rc = _kernel()(pred.data_ptr(), gt.data_ptr(), out.data_ptr(), b, n,
                   gt.shape[1],
                   torch.cuda.current_stream(pred.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"best_iou kernel launch failed: CUDA error {rc} "
                           f"at pred {tuple(pred.shape)}, gt "
                           f"{tuple(gt.shape)}")
    with _launches_lock:
        best_iou.launches += 1
    return out


best_iou.launches = 0
