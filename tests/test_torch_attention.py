"""Port attention (deepvision_tpu_torch/ops/attention.py) against the JAX
package's attention on the CPU.

The same numpy inputs (seeded) go through both: the port's
`flash_attention_reference` — the plain version of the CUDA kernel, same
key-tile loop, running max/sum and -inf masking, and in bf16 the tensor-core
path's roundings — against JAX `attention(impl="interpret")` (the Pallas
kernel under the interpreter) and `impl="naive"`, and the port's
`naive_attention` against JAX `impl="naive"`. Bounds are the
JAX package's own fused-vs-naive ones (tests/test_vit.py): 2e-5 in f32,
where only the summation order differs, and 2e-2 in bf16, one rounding of
a unit-scale output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.ops.attention import attention as jax_attention
from deepvision_tpu_torch.ops import attention as port

BOUND = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [(2, 3, n, 16) for n in (5, 17, 33, 197)] + \
         [(2, 6, n, 64) for n in (5, 17, 33, 197)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _qkv(shape, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


def _both(arrays, dtype):
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flash_reference_matches_jax_interpret(shape, dtype):
    jx, tx = _both(_qkv(shape, seed=shape[2]), dtype)
    want = np.asarray(jax_attention(*jx, impl="interpret").astype(jnp.float32))
    got = port.flash_attention_reference(*tx)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    assert np.abs(got.float().numpy() - want).max() <= BOUND[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flash_reference_matches_jax_naive(shape, dtype):
    jx, tx = _both(_qkv(shape, seed=shape[2] + 2), dtype)
    want = np.asarray(jax_attention(*jx, impl="naive").astype(jnp.float32))
    got = port.flash_attention_reference(*tx)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    assert np.abs(got.float().numpy() - want).max() <= BOUND[dtype]


def test_bf16_reference_rounds_p_and_scales_after_the_product():
    """The bf16 branch repeats the tensor-core kernel's roundings: one key
    tile, so it equals softmax(f32(Q K^T) · scale) rounded to bf16 before
    P V in f32 — up to the normalization by the f32 sum, applied last."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv((1, 2, 9, 16)))
    s = (q.float() @ k.float().transpose(-1, -2)) * 0.25
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = (p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)
    got = port.flash_attention_reference(q, k, v)
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("case,vec16", [
    ("contiguous", True), ("head_split_view", True), ("offset_1", False),
    ("head_dim_12", False), ("row_stride_4", False), ("batch_1_any_stride",
                                                       True)])
def test_vector_copy_selection(case, vec16):
    """16-byte copies need every row on 16 bytes (data_ptr, b/h/n strides
    in multiples of 8 elements, D % 8 == 0); everything else takes the
    same kernel with scalar copies. Strides of size-1 dims do not count."""
    bf = torch.bfloat16
    t = {
        "contiguous": lambda: torch.zeros(2, 3, 33, 64, dtype=bf),
        "head_split_view": lambda: torch.zeros(2, 33, 6 * 64, dtype=bf)
        .view(2, 33, 6, 64).permute(0, 2, 1, 3),
        "offset_1": lambda: torch.zeros(2 * 3 * 33 * 64 + 1, dtype=bf)[1:]
        .view(2, 3, 33, 64),
        "head_dim_12": lambda: torch.zeros(2, 3, 33, 12, dtype=bf),
        "row_stride_4": lambda: torch.zeros(2, 3, 33, 68, dtype=bf)[..., :64],
        "batch_1_any_stride": lambda: torch.zeros(1, 3, 33, 64, dtype=bf)
        .as_strided((1, 3, 33, 64), (5, 33 * 64, 64, 1)),
    }[case]()
    assert port._vector_copies_ok(t, t, t) is vec16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_naive_matches_jax_naive(shape, dtype):
    jx, tx = _both(_qkv(shape, seed=shape[2] + 1), dtype)
    want = np.asarray(jax_attention(*jx, impl="naive").astype(jnp.float32))
    got = port.naive_attention(*tx)
    assert got.dtype == getattr(torch, dtype)
    assert np.abs(got.float().numpy() - want).max() <= BOUND[dtype]


def test_auto_on_cpu_takes_the_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 33, 16)))
    before = port.flash_attention.launches
    out = port.attention(q, k, v, impl="auto")
    assert port.flash_attention.launches == before
    torch.testing.assert_close(out, port.flash_attention_reference(q, k, v),
                               rtol=0, atol=0)


def test_head_split_view_needs_no_copy():
    """The model hands the kernel (B, N, H, D) projections viewed as
    (B, H, N, D): only D needs unit stride, and the answer equals the
    contiguous one."""
    x = torch.from_numpy(_qkv((2, 17, 3 * 16))[0])
    view = x.view(2, 17, 3, 16).permute(0, 2, 1, 3)
    assert not view.is_contiguous()
    torch.testing.assert_close(
        port.flash_attention(view, view, view),
        port.naive_attention(*(view.contiguous(),) * 3),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["float16", "head_dim", "d_stride", "shapes",
                                  "rank"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    q = torch.zeros(1, 2, 5, 16)
    args = {
        "float16": (q.half(),) * 3,
        "head_dim": (torch.zeros(1, 2, 5, 129),) * 3,
        "d_stride": (q.transpose(2, 3),) * 3,
        "shapes": (q, q, torch.zeros(1, 2, 6, 16)),
        "rank": (q[0],) * 3,
    }[case]
    with pytest.raises((TypeError, ValueError)):
        port.flash_attention(*args)


def test_unknown_impl_raises():
    q = torch.zeros(1, 1, 2, 4)
    with pytest.raises(ValueError, match="unknown attention impl"):
        port.attention(q, q, q, impl="interpret")


def test_grad_guard_predicate_and_the_cpu_path_still_backpropagates():
    """The kernel has no backward yet, so the CUDA branch refuses a call
    that autograd would record (`_needs_backward`); the CPU path is the
    plain version, which autograd differentiates like naive attention."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 9, 16), seed=3))
    assert not port._needs_backward(q, k, v)
    q.requires_grad_(True)
    assert port._needs_backward(q, k, v)
    with torch.no_grad():
        assert not port._needs_backward(q, k, v)
    with torch.inference_mode():
        assert not port._needs_backward(q, k, v)
    out = port.flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.square().sum().backward()
    q2 = q.detach().clone().requires_grad_(True)
    port.naive_attention(q2, k, v).square().sum().backward()
    torch.testing.assert_close(q.grad, q2.grad, rtol=2e-5, atol=2e-5)
