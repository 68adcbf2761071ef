"""Multi-head attention on (B, H, N, D): softmax(Q K^T · scale) V.

Port of deepvision_tpu/ops/attention.py. Three versions of one function:

- `naive_attention`: both contractions at the operand dtype, only the
  softmax promoted to f32 — the JAX package's `naive_attention`, rounding
  for rounding in intent.
- `flash_attention_reference`: the plain PyTorch version of the kernel —
  the same key-tile loop, running max `m` and sum `l`, -inf masking of keys
  past N and f32 accumulation, with the bf16 path's roundings (P to bf16
  before P V), so the algorithm is checked on the CPU.
- `flash_attention`: the wrapper of the hand-written CUDA kernel
  (csrc/flash_attention.cu, which replaces the Pallas kernel
  deepvision_tpu/ops/attention.py:73). A CUDA tensor launches the kernel
  or raises; only a CPU tensor takes the plain version. There is no
  fallback and no switch that takes the kernel off the path.

`attention(impl="auto")` — what the ViT calls — goes to `flash_attention`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from ._build import load_library

# PyTorch runs this module eagerly and no JAX trace reaches it
# (tests/test_torch_isolation.py); jaxlint's project-wide trace reach
# resolves calls by name and takes it for deepvision_tpu/ops/attention.py.
# jaxlint: disable-file=TRC001

#: keys per tile of the plain version: the kernel's K/V tile (bf16, and
#: f32 for D <= 64)
BLOCK_K = 64
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _default_scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Reference dot-product attention: the (N, N) scores are materialized,
    both contractions run at the operand dtype and only the softmax is
    promoted to f32 (deepvision_tpu/ops/attention.py:51-70)."""
    scale = _default_scale(q, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    p = torch.softmax(s.float() * scale, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: walk fixed-size key tiles
    (the last one zero-padded, its keys past N masked to -inf before the
    max), keep the running max `m`, the running sum `l` and an accumulator
    rescaled by exp(m_old - m_new), all in f32, and cast once at the end.

    f32 inputs scale Q before Q K^T, as the kernel's CUDA-core path does.
    bf16 inputs follow its tensor-core path: S from bf16 Q and K with f32
    accumulation (an f32 product of the upcast values is exact), scaled in
    f32; P rounded to bf16 before P V, as the reference's
    `p.astype(v.dtype)` does; the sum `l` over the f32 P."""
    scale = _default_scale(q, scale)
    b, h, n, d = q.shape
    low = q.dtype == torch.bfloat16
    qf = q.float() if low else q.float() * scale
    m = torch.full((b, h, n, 1), -math.inf, device=q.device)
    l = torch.zeros((b, h, n, 1), device=q.device)
    acc = torch.zeros((b, h, n, d), device=q.device)
    for k0 in range(0, n, BLOCK_K):
        nk = min(BLOCK_K, n - k0)
        kj = torch.zeros((b, h, BLOCK_K, d), device=q.device)
        vj = torch.zeros((b, h, BLOCK_K, d), device=q.device)
        kj[:, :, :nk] = k[:, :, k0:k0 + nk].float()
        vj[:, :, :nk] = v[:, :, k0:k0 + nk].float()
        s = qf @ kj.transpose(-1, -2)
        if low:
            s = s * scale
        key_idx = k0 + torch.arange(BLOCK_K, device=q.device)
        s = s.masked_fill(key_idx >= n, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if low:
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha + p @ vj
        m = m_new
    return (acc / l).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernel takes: one device, f32 or bf16, equal (B, H, N, D)
    shapes with D <= 128, unit stride along D."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, N, D), got {tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} dtype {t.dtype} unsupported "
                            f"(float32 or bfloat16)")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride along D, got "
                             f"strides {t.stride()}")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, "
                         f"{v.device}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} > {MAX_HEAD_DIM}")
    if min(q.shape) < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")


def _needs_backward(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> bool:
    """Whether autograd would record this call: the kernel writes a fresh
    tensor with no grad_fn, so a backward through it would silently give
    every input before the attention a zero gradient."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))


def _vector_copies_ok(*tensors: torch.Tensor) -> bool:
    """Whether the bf16 kernel may copy rows with 16-byte `cp.async`: every
    tensor starts on 16 bytes, its b/h/n strides are multiples of 8
    elements (strides of size-1 dims never move a pointer) and D % 8 == 0.
    Anything else takes the same kernel with scalar copies."""
    if tensors[0].shape[-1] % 8:
        return False
    return all(t.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st, sz in zip(t.stride()[:3],
                                                     t.shape[:3]) if sz > 1)
               for t in tensors)


_launches_lock = threading.Lock()


@functools.cache
def _kernel():
    fn = load_library("flash_attention").dv_flash_attention_forward
    # pointers and the stream as c_void_p: untyped, ctypes would pass them
    # as 32-bit ints and cut them
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash-attention forward on (B, H, N, D) f32 or bf16 tensors.

    On a CUDA tensor this launches the kernel on the current stream and
    counts the launch in `flash_attention.launches`; the output is
    allocated as a (B, N, H, D) tensor and returned as its (B, H, N, D)
    view, so merging the heads back is free. bf16 copies rows with 16-byte
    `cp.async` where `_vector_copies_ok` allows it, else with scalar copies
    in the same kernel. The kernel has no backward yet: a CUDA input that
    requires a gradient, with grad mode on, raises. On a CPU tensor it
    returns `flash_attention_reference`, which autograd differentiates. Any
    other device raises."""
    _check(q, k, v)
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if _needs_backward(q, k, v):
        raise RuntimeError(
            "flash_attention has no backward kernel yet (it is still to "
            "port, with ViT training): call it under torch.no_grad() or "
            "torch.inference_mode(), or on inputs that do not require a "
            "gradient")
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    # a size-1 dim's stride never moves a pointer: pass 0 so the kernel's
    # own alignment check agrees with _vector_copies_ok
    strides = [st if sz > 1 else 0 for t in (q, k, v, out)
               for st, sz in zip(t.stride()[:3], t.shape[:3])]
    vec16 = q.dtype == torch.bfloat16 and _vector_copies_ok(q, k, v, out)
    # the launcher runs on the current device, which must own the stream
    with torch.cuda.device(q.device):
        rc = _kernel()(_DTYPE_CODES[q.dtype], int(vec16), q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n,
                       d, *strides, scale,
                       torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} at shape {tuple(q.shape)} {q.dtype}")
    with _launches_lock:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              impl: str = "auto",
              scale: Optional[float] = None) -> torch.Tensor:
    """softmax(Q K^T · scale) V on (B, H, N, D). impl: "auto" | "fused"
    (both the flash kernel on a CUDA tensor and its plain version on a CPU
    tensor) | "naive"."""
    if impl in ("auto", "fused"):
        return flash_attention(q, k, v, scale=scale)
    if impl == "naive":
        return naive_attention(q, k, v, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
