"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (marker `cuda`) and skips without one.
This file imports neither JAX nor the JAX package, so it runs where only
the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bounds for flash_attention: 2e-5 in f32 (only the summation order
differs; TF32 is switched off for the plain version's matmuls), 2e-2 in
bf16 (tensor-core products with f32 accumulation against the plain
version's exact f32 products of the same bf16 values, P rounded to bf16 on
both sides, one bf16 rounding of a unit-scale output). For best_iou: rtol and atol 1e-6, the JAX package's bound — the
kernel runs the plain version's f32 operations in the same order — and
bit for bit for the fused segments (NaN where the plain version has NaN,
equal values elsewhere; +0 and -0 compare equal).
"""

import os
import sys

import pytest
import torch

from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.detection import (make_yolo_eval_step,
                                                 make_yolo_train_step)
from deepvision_tpu_torch.core.optim import AdamChain
from deepvision_tpu_torch.core.schedules import build_schedule
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.data.detection import synthetic_batches
from deepvision_tpu_torch.models import build_model
from deepvision_tpu_torch.ops import attention as port
from deepvision_tpu_torch.ops import best_iou as k2

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (padded_gt, ragged_gt, ragged_preds,  # noqa: E402
                        random_boxes, same)

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


def _matches_plain_with_one_launch(q, k, v, dtype):
    before = port.flash_attention.launches
    out = port.flash_attention(q, k, v)
    assert port.flash_attention.launches == before + 1
    ref = port.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= BOUND[dtype]


@pytest.mark.parametrize("n", [1, 5, 17, 63, 64, 65, 197, 300])
def test_bf16_kernel_ragged_n(card, n):
    """Key tiles of 64 and query tiles of 64: N below, at and past both."""
    _matches_plain_with_one_launch(*_qkv((2, 3, n, 64), torch.bfloat16,
                                         seed=n), torch.bfloat16)


@pytest.mark.parametrize("d", [8, 16, 40, 64, 128])
def test_bf16_kernel_head_dims(card, d):
    """D zero-padded to 64 or 128 in shared memory."""
    _matches_plain_with_one_launch(*_qkv((2, 3, 77, d), torch.bfloat16,
                                         seed=d), torch.bfloat16)


def test_bf16_kernel_vit_small_bucket_32_strided(card):
    """What vit_small's bucket 32 hands the kernel: (B, N, H*D) projections
    viewed as (B, H, N, D), 16-byte copies."""
    q, k, v = (x.view(32, 197, 6, 64).permute(0, 2, 1, 3)
               for x in _qkv((32, 197, 384), torch.bfloat16, seed=32))
    assert port._vector_copies_ok(q, k, v)
    _matches_plain_with_one_launch(q, k, v, torch.bfloat16)


@pytest.mark.parametrize("case", ["offset_1", "head_dim_12"])
def test_bf16_kernel_misaligned_takes_scalar_copies(card, case):
    """Rows off 16 bytes take the same kernel with scalar copies: it still
    launches, and it still agrees with the plain version."""
    if case == "offset_1":
        flat = _qkv((2 * 3 * 33 * 64 + 1,), torch.bfloat16, seed=1)
        q, k, v = (x[1:].view(2, 3, 33, 64) for x in flat)
    else:
        q, k, v = _qkv((2, 3, 33, 12), torch.bfloat16, seed=12)
    assert not port._vector_copies_ok(q, k, v)
    _matches_plain_with_one_launch(q, k, v, torch.bfloat16)


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


@pytest.mark.parametrize("b,n,m", [(16, 8112, 100), (16, 2028, 100),
                                   (16, 507, 100), (16, 1, 100), (3, 130, 3),
                                   (2, 64, 1), (2, 70, 300), (1, 1, 1)],
                         ids=str)
def test_best_iou_matches_plain_version(card, b, n, m):
    gen = torch.Generator().manual_seed(n + m)
    pred = random_boxes(b, n, gen).cuda()
    gt = random_boxes(b, m, gen)
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


@pytest.mark.parametrize("b,segments,m", [
    (16, (8112, 2028, 507), 100),      # yolov3 at 416 px
    (1, (8112, 2028, 507), 100),       # batch 1
    (3, (1, 130, 507), 3),
    (2, (507, 1), 1),
    (2, (130, 1, 507), 300),           # more GT than one shared-memory chunk
    (2, (33,) * 8, 7),                 # the most segments one launch takes
], ids=str)
def test_best_iou_fused_segments_are_bit_for_bit(card, b, segments, m):
    gen = torch.Generator().manual_seed(sum(segments) + m)
    preds = [random_boxes(b, n, gen).cuda() for n in segments]
    gt = padded_gt(b, m, gen).cuda()
    before = k2.best_iou.launches
    outs = k2.best_iou(preds, gt)
    assert k2.best_iou.launches == before + 1
    refs = k2.best_iou_reference(preds, gt)
    assert [tuple(o.shape) for o in outs] == [(b, n) for n in segments]
    assert all(same(o, r) for o, r in zip(outs, refs))


def test_best_iou_fused_nan_inf_and_inverted_boxes(card):
    gen = torch.Generator().manual_seed(11)
    preds = [p.cuda() for p in ragged_preds(gen)]
    gt = ragged_gt(gen).cuda()
    outs = k2.best_iou(preds, gt)
    refs = k2.best_iou_reference(preds, gt)
    assert torch.isnan(refs[1][1, 0])     # the zero union
    assert any(torch.isnan(r).any() for r in refs)
    assert any((r > 0).any() for r in refs)
    assert all(same(o, r) for o, r in zip(outs, refs))


def test_best_iou_fused_captures_into_a_cuda_graph(card):
    gen = torch.Generator().manual_seed(12)
    preds = [random_boxes(16, n, gen).cuda() for n in (8112, 2028, 507)]
    gt = padded_gt(16, 100, gen).cuda()
    want = k2.best_iou(preds, gt)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k2.best_iou(preds, gt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = k2.best_iou(preds, gt)
    for out in got:
        out.fill_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_best_iou_refuses_no_segment_or_too_many(card):
    gt = torch.rand(2, 3, 4, device="cuda")
    with pytest.raises(ValueError):
        k2.best_iou([], gt)
    with pytest.raises(ValueError):
        k2.best_iou([torch.rand(2, 5, 4, device="cuda")]
                    * (k2.MAX_SEGMENTS + 1), gt)


def test_yolo_train_step_on_the_card_launches_once_per_step(card):
    cfg = get_config("yolov3_digits")
    model = build_model(cfg).to("cuda")
    opt = AdamChain(model.parameters(), cfg.optimizer,
                    build_schedule(cfg.schedule, 1e-3, 10))
    state = TrainState(model, opt)
    kw = dict(num_classes=10, grid_sizes=(8, 4, 2))
    step = make_yolo_train_step(**kw)
    eval_step = make_yolo_eval_step(**kw)
    batch = [torch.from_numpy(a).cuda() for a in next(synthetic_batches(
        batch_size=2, image_size=64, num_classes=10, steps=1))]
    before = k2.best_iou.launches
    metrics = eval_step(state, *batch)
    assert k2.best_iou.launches - before == 1
    assert torch.isfinite(metrics["loss"])
    metrics = step(state, *batch)
    assert k2.best_iou.launches - before == 2
    assert all(torch.isfinite(v) for v in metrics.values())
