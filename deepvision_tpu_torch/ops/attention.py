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
  fallback and no switch that takes the kernel off the path. Every call
  goes through one registered operator, `deepvision::flash_attention`
  (`flash_attention_op`): its CUDA implementation launches the kernel,
  its CPU implementation is the plain version, its fake gives the
  kernel's output strides, so `torch.export` records one node per call
  and an AOTInductor package calls the operator, never an inlined plain
  version. Its autograd formula is the VJP of `naive_attention`,
  recomputed from the saved q, k and v, as the JAX package's
  `fused_attention` custom_vjp does (`_fused_bwd`): the JAX package has
  no backward kernel, so the port has none either.

`attention(impl="auto")` — what the ViT calls — goes to `flash_attention`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch
from torch.overrides import handle_torch_function, has_torch_function

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


def _output_like(q: torch.Tensor) -> torch.Tensor:
    """The kernel's output for `q`'s (B, H, N, D): a (B, N, H, D) tensor
    seen as (B, H, N, D), so merging the heads back is a view. The CPU
    implementation and the fake return the same strides, so a traced graph
    and the tensor it runs on agree on the layout."""
    b, h, n, d = q.shape
    return q.new_empty((b, n, h, d)).permute(0, 2, 1, 3)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    """One launch of the kernel on the current stream, counted in
    `flash_attention.launches`, into `_output_like(q)`."""
    b, h, n, d = q.shape
    out = _output_like(q)
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


def _like(t: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """`grad` laid out with `t`'s strides, so the model's head-split views
    pass their gradients back without another copy."""
    if grad.stride() == t.stride():
        return grad
    return torch.empty_like(t).copy_(grad)


@torch.library.custom_op("deepvision::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """The registered operator `deepvision::flash_attention`, which every
    call of `flash_attention` goes through: a traced or exported graph
    holds it as one opaque node, and an AOTInductor package calls it
    through its proxy executor. On a CPU tensor (this implementation) it
    returns the plain version; on a CUDA tensor it launches the kernel
    (`_cuda_impl`); no other device has an implementation. Each
    implementation checks its inputs (`_check`) once a call."""
    _check(q, k, v)
    out = _output_like(q)
    out.copy_(flash_attention_reference(q, k, v, scale=scale))
    return out


@flash_attention_op.register_kernel("cuda")
def _cuda_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float) -> torch.Tensor:
    _check(q, k, v)
    return _launch(q, k, v, scale)


@flash_attention_op.register_fake
def _fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          scale: float) -> torch.Tensor:
    _check(q, k, v)          # a trace refuses what the kernel would
    return _output_like(q)


def _setup_context(ctx, inputs, output) -> None:
    q, k, v, scale = inputs
    ctx.save_for_backward(q, k, v)
    ctx.scale = scale


def _backward(ctx, grad_out):
    """The VJP of `naive_attention` at the saved q, k, v (the scores
    recomputed, contractions at the operand dtype, only the softmax in
    f32), as the JAX package's `_fused_bwd`; it launches no kernel."""
    inputs = [t.detach().requires_grad_(need) for t, need
              in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        out = naive_attention(*inputs, scale=ctx.scale)
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return (*(_like(t, next(grads)) if t.requires_grad else None
              for t in inputs), None)


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash-attention forward on (B, H, N, D) f32 or bf16 tensors, with
    the naive VJP as its backward.

    On a CUDA tensor this launches the kernel on the current stream and
    counts the launch in `flash_attention.launches`; the output is a
    (B, N, H, D) tensor returned as its (B, H, N, D) view, so merging the
    heads back is free. bf16 copies rows with 16-byte `cp.async` where
    `_vector_copies_ok` allows it, else with scalar copies in the same
    kernel. On a CPU tensor it returns `flash_attention_reference` in the
    same layout. Both go through the operator
    `deepvision::flash_attention`, which checks the inputs and has no
    implementation for any other device. The backward is the naive VJP and
    launches no kernel of its own. A torch function mode sees each call
    as one call of this function (the int8 plan counts it as fused
    attention)."""
    if has_torch_function((q, k, v)):
        return handle_torch_function(flash_attention, (q, k, v), q, k, v,
                                     scale=scale)
    return flash_attention_op(q, k, v, _default_scale(q, scale))


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
