"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (marker `cuda`) and skips without one.
This file imports neither JAX nor the JAX package, so it runs where only
the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bounds: 2e-5 in f32 (only the summation order differs; TF32 is switched
off for the plain version's matmuls), 2e-2 in bf16 (f32 accumulation on
both sides, one bf16 rounding of a unit-scale output).
"""

import pytest
import torch

from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.models import build_model
from deepvision_tpu_torch.ops import attention as port

pytestmark = pytest.mark.cuda
BOUND = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _qkv(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to("cuda", dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(1, 6, 197, 64), (3, 2, 5, 16),
                                   (2, 3, 300, 32), (2, 2, 130, 128),
                                   (1, 1, 1, 8), (2, 6, 197, 40)], ids=str)
def test_kernel_matches_plain_version(card, shape, dtype):
    q, k, v = _qkv(shape, dtype, seed=shape[2])
    before = port.flash_attention.launches
    out = port.flash_attention(q, k, v)
    assert port.flash_attention.launches == before + 1
    ref = port.flash_attention_reference(q, k, v)
    assert out.shape == shape and out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= BOUND[dtype]


def test_kernel_takes_strided_head_split_views(card):
    x = torch.randn(4, 197, 384, device="cuda", dtype=torch.bfloat16)
    view = x.view(4, 197, 6, 64).permute(0, 2, 1, 3)
    out = port.flash_attention(view, view, view, scale=0.3)
    ref = port.flash_attention_reference(*(view.contiguous(),) * 3, scale=0.3)
    assert (out.float() - ref.float()).abs().max().item() <= BOUND[torch.bfloat16]
    # the output is a (B, N, H, D) buffer: merging heads back is a view
    assert out.permute(0, 2, 1, 3).is_contiguous()


def test_kernel_refuses_float16(card):
    q, k, v = _qkv((1, 1, 4, 8), torch.float16)
    with pytest.raises(TypeError):
        port.flash_attention(q, k, v)


def test_vit_forward_on_the_card_launches_once_per_block(card):
    cfg = get_config("vit_tiny")
    model = build_model(cfg).eval().to("cuda").cast_compute_weights_()
    x = torch.randn(3, 32, 32, 3, device="cuda")
    before = port.flash_attention.launches
    with torch.inference_mode():
        out = model(x)
    assert port.flash_attention.launches - before == cfg.model_kwargs["depth"]
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
