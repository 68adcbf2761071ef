"""Best IoU of each predicted box against the ground truth — the YOLO
ignore mask's hot spot: out[b, n] = max_m IoU(pred[b, n], gt[b, m]).

Port of deepvision_tpu/ops/pallas_kernels.py, named after what it
computes. Two versions of one function, each taking one (B, N, 4) tensor
of predicted boxes or a sequence of them (segments: the YOLO scales), all
against one (B, M, 4) GT tensor:

- `best_iou_reference`: the plain PyTorch version — `broadcast_iou` and a
  max over M, segment by segment and one tile of `BLOCK_N` predicted boxes
  at a time, as the TPU kernel tiles N, so only a (B, BLOCK_N, M)
  intermediate ever exists.
- `best_iou`: the wrapper of the hand-written CUDA kernel
  (csrc/best_iou.cu, which replaces the Pallas kernel
  deepvision_tpu/ops/pallas_kernels.py:33). A CUDA tensor launches the
  kernel or raises — a sequence of up to `MAX_SEGMENTS` segments in one
  launch, with no concatenation copy; only a CPU tensor takes the plain
  version. There is no fallback and no switch that takes the kernel off
  the path.

Both work on detached inputs: the YOLO loss consumes the result through a
`<` (the JAX package wraps it in stop_gradient), so it has no gradient.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Sequence, Union

import torch

from ._build import load_library
from .boxes import broadcast_iou

# PyTorch runs this module eagerly and no JAX trace reaches it
# (tests/test_torch_isolation.py); jaxlint's project-wide trace reach
# resolves calls by name and takes `best_iou` for the JAX package's jitted
# one (deepvision_tpu/ops/pallas_kernels.py).
# jaxlint: disable-file=TRC001

#: predicted boxes per tile of the plain version: the TPU kernel's block_n
BLOCK_N = 512
#: dtypes the wrapper takes; both go to the kernel as f32, as the JAX
#: package casts to f32 (pallas_kernels.py:79-80)
_DTYPES = (torch.float32, torch.float64)
#: segments one launch takes (kMaxSegments in csrc/best_iou.cu)
MAX_SEGMENTS = 8

Boxes = Union[torch.Tensor, Sequence[torch.Tensor]]


def _reference_one(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    b, n, _ = pred.shape
    out = torch.empty((b, n), dtype=torch.float32, device=pred.device)
    for n0 in range(0, n, BLOCK_N):
        out[:, n0:n0 + BLOCK_N] = broadcast_iou(
            pred[:, n0:n0 + BLOCK_N], gt).amax(dim=-1)
    return out


def best_iou_reference(pred_boxes: Boxes, gt_boxes: torch.Tensor
                       ) -> Union[torch.Tensor, List[torch.Tensor]]:
    """max_m IoU(pred_n, gt_m): (B, N, 4) x (B, M, 4) corner boxes → (B, N)
    f32, in tiles of BLOCK_N predicted boxes; a sequence of (B, N_s, 4)
    segments gives the list of their (B, N_s) results."""
    gt = gt_boxes.detach().float()
    if isinstance(pred_boxes, torch.Tensor):
        return _reference_one(pred_boxes.detach().float(), gt)
    return [_reference_one(p.detach().float(), gt) for p in pred_boxes]


def _check(preds: Sequence[torch.Tensor], gt: torch.Tensor) -> None:
    """What the kernel takes: 1 to MAX_SEGMENTS segments (B, N_s, 4) and a
    (B, M, 4) GT on one device, N_s, M, B >= 1, f32 (or f64, cast to
    f32)."""
    if not 1 <= len(preds) <= MAX_SEGMENTS:
        raise ValueError(f"{len(preds)} segments of pred_boxes: one launch "
                         f"takes 1 to {MAX_SEGMENTS}")
    for name, t in [("gt_boxes", gt)] + [("pred_boxes", p) for p in preds]:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dim() != 3 or t.shape[-1] != 4:
            raise ValueError(f"{name} must be (B, N, 4), got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} dtype {t.dtype} unsupported (float32, "
                            f"or float64 cast to float32)")
        if min(t.shape) < 1:
            raise ValueError(f"empty {name} {tuple(t.shape)}")
        if t.shape[0] != gt.shape[0]:
            raise ValueError(f"batch sizes differ: {t.shape[0]} in {name}, "
                             f"{gt.shape[0]} ground truth")
        if t.device != gt.device:
            raise ValueError(f"{name} on {t.device}, gt_boxes on "
                             f"{gt.device}")


_launches_lock = threading.Lock()


@functools.cache
def _kernel():
    fn = load_library("best_iou").dv_best_iou
    # pointers and the stream as c_void_p: untyped, ctypes would pass them
    # as 32-bit ints and cut them
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def best_iou(pred_boxes: Boxes, gt_boxes: torch.Tensor
             ) -> Union[torch.Tensor, List[torch.Tensor]]:
    """max_m IoU(pred_n, gt_m): (B, N, 4) x (B, M, 4) corner boxes → (B, N)
    f32; a sequence of 1 to MAX_SEGMENTS (B, N_s, 4) segments gives the
    list of their (B, N_s) results. Padded GT rows must be zeroed by the
    caller (zero area → IoU 0).

    On a CUDA tensor this launches the kernel once on the current stream,
    for all segments, and counts the launch in `best_iou.launches`. On a
    CPU tensor it returns `best_iou_reference`. Any other device raises."""
    single = isinstance(pred_boxes, torch.Tensor)
    preds = [pred_boxes] if single else list(pred_boxes)
    _check(preds, gt_boxes)
    device = gt_boxes.device
    if device.type == "cpu":
        return best_iou_reference(pred_boxes, gt_boxes)
    if device.type != "cuda":
        raise ValueError(f"best_iou runs on cuda or cpu, got {device}")
    preds = [p.detach().float().contiguous() for p in preds]
    gt = gt_boxes.detach().float().contiguous()
    b, k = gt.shape[0], len(preds)
    outs = [torch.empty((b, p.shape[1]), dtype=torch.float32, device=device)
            for p in preds]
    rc = _kernel()((ctypes.c_void_p * k)(*[p.data_ptr() for p in preds]),
                   (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]),
                   (ctypes.c_int * k)(*[p.shape[1] for p in preds]), k,
                   gt.data_ptr(), b, gt.shape[1],
                   torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"best_iou kernel launch failed: CUDA error {rc} "
                           f"at pred {[tuple(p.shape) for p in preds]}, gt "
                           f"{tuple(gt.shape)}")
    with _launches_lock:
        best_iou.launches += 1
    return outs[0] if single else outs


best_iou.launches = 0
