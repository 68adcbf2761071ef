"""Port attention (deepvision_tpu_torch/ops/attention.py) against the JAX
package's attention on the CPU.

The same numpy inputs (seeded) go through both: the port's
`flash_attention_reference` — the plain version of the CUDA kernel, same
key-tile loop, running max/sum and -inf masking — against JAX
`attention(impl="interpret")` (the Pallas kernel under the interpreter),
and the port's `naive_attention` against JAX `impl="naive"`. Bounds are the
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
