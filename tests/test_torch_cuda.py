"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (marker `cuda`) and skips without one.
This file imports neither JAX nor the JAX package, so it runs where only
the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bounds for flash_attention: 2e-5 in f32 (only the summation order
differs; TF32 is switched off for the plain version's matmuls), 2e-2 in
bf16 (f32 accumulation on both sides, one bf16 rounding of a unit-scale
output). For best_iou: rtol and atol 1e-6, the JAX package's bound — the
kernel runs the plain version's f32 operations in the same order.
"""

import pytest
import torch

from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.detection import make_yolo_train_step
from deepvision_tpu_torch.core.optim import AdamChain
from deepvision_tpu_torch.core.schedules import build_schedule
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.data.detection import synthetic_batches
from deepvision_tpu_torch.models import build_model
from deepvision_tpu_torch.ops import attention as port
from deepvision_tpu_torch.ops import best_iou as k2

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


def test_kernel_refuses_an_input_that_needs_a_gradient(card):
    q, k, v = _qkv((1, 2, 9, 16), torch.float32)
    q.requires_grad_(True)
    before = port.flash_attention.launches
    with pytest.raises(RuntimeError, match="backward"):
        port.flash_attention(q, k, v)
    assert port.flash_attention.launches == before
    with torch.no_grad():
        out = port.flash_attention(q, k, v)
    assert out.grad_fn is None and port.flash_attention.launches == before + 1


def _boxes(b, n, gen):
    xy = torch.rand(b, n, 2, generator=gen) * 0.9
    wh = torch.rand(b, n, 2, generator=gen) * 0.35
    return torch.cat([xy, xy + wh], dim=-1)


@pytest.mark.parametrize("b,n,m", [(16, 8112, 100), (16, 2028, 100),
                                   (16, 507, 100), (16, 1, 100), (3, 130, 3),
                                   (2, 64, 1), (2, 70, 300), (1, 1, 1)],
                         ids=str)
def test_best_iou_matches_plain_version(card, b, n, m):
    gen = torch.Generator().manual_seed(n + m)
    pred = _boxes(b, n, gen).cuda()
    gt = _boxes(b, m, gen)
    gt[:, m // 2 + 1:] = 0.0                    # zero-GT padding rows
    gt = gt.cuda()
    before = k2.best_iou.launches
    out = k2.best_iou(pred, gt)
    assert k2.best_iou.launches == before + 1
    ref = k2.best_iou_reference(pred, gt)
    assert out.shape == (b, n) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)


def test_best_iou_exact_match_and_all_padding(card):
    gt = torch.tensor([[[0.1, 0.2, 0.5, 0.7], [0.0, 0.0, 0.0, 0.0]],
                       [[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]]],
                      device="cuda")
    pred = torch.tensor([[[0.1, 0.2, 0.5, 0.7]], [[0.1, 0.2, 0.5, 0.7]]],
                        device="cuda")
    out = k2.best_iou(pred, gt).cpu()
    assert abs(out[0, 0].item() - 1.0) < 1e-6 and out[1, 0].item() == 0.0


def test_best_iou_refuses_bfloat16_and_bad_shapes(card):
    pred = torch.rand(2, 5, 4, device="cuda")
    gt = torch.rand(2, 3, 4, device="cuda")
    with pytest.raises(TypeError):
        k2.best_iou(pred.bfloat16(), gt.bfloat16())
    with pytest.raises(ValueError):
        k2.best_iou(pred, gt[:1])
    with pytest.raises(ValueError):
        k2.best_iou(pred[..., :3], gt)


def test_yolo_train_step_on_the_card_launches_once_per_scale(card):
    cfg = get_config("yolov3_digits")
    model = build_model(cfg).to("cuda")
    opt = AdamChain(model.parameters(), cfg.optimizer,
                    build_schedule(cfg.schedule, 1e-3, 10))
    state = TrainState(model, opt)
    step = make_yolo_train_step(num_classes=10, grid_sizes=(8, 4, 2))
    batch = next(synthetic_batches(batch_size=2, image_size=64,
                                   num_classes=10, steps=1))
    before = k2.best_iou.launches
    metrics = step(state, *(torch.from_numpy(a).cuda() for a in batch))
    assert k2.best_iou.launches - before == 3
    assert all(torch.isfinite(v) for v in metrics.values())
