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

The ResNet slice has no kernel: its card tests hold the prefetcher, the
device augment and a reduced ResNet's forward and train step on the card
against the CPU, in f32 (cuDNN and cuBLAS with TF32 off): 1e-5 relative to
the largest logit or gradient for the forward, 1e-4 for the gradients of a
train step (BatchNorm in train mode over few values amplifies summation
order), 1e-4 absolute for the augment (its means sum in another order).

The zoo slice has no kernel either: for each family at a reduced size
(10 classes; AlexNet V2 at 67 px, VGG-16, MobileNet V1 at alpha 0.25 and
ShuffleNet V1 at 32 px, Inception V1 at 96 and V3 at 107), the f32 eval
forward on the card against the CPU within 1e-5 of the largest logit, and
one train step of the config's recipe (dropout rates set to 0: the
card's masks and the CPU's come from different generators) on the card in
f64 and in f32, each against the same step in f64 on the CPU
(chip_smoke.py's `check_step_against_f64`): in f64 within 1e-12 (loss) and
1e-9 of the largest gradient, the same function; in f32 within 2e-4 and
1e-1, because at random init and 4 images train-mode BatchNorm leaves the
first convs' and the depthwise convs' weight gradients small remainders of
large terms, whose f32 error depends on the summation order (the CPU's
own f32 gradients lie percent of the largest gradient from the f64 ones,
chip_smoke.py phase 9 prints it at full size), so card and CPU cannot
agree to 1e-4 as the ResNet's do; and `mobilenet_v1` served by the engine on
the card at its full size, padded buckets against `reference()` within
5e-2 of the largest logit (bf16 on both sides) and against an engine on
the CPU on the same seeded weights within 5e-2.

int8 serving has no TPU kernel either (JAX's int8 conv and dot are XLA
ops): `ops/quant.py`'s int8 products on the card (the padded
`torch._int_mm`, im2col convs at k = 25, 27 and 147, a 1x1, depthwise and
grouped convs) give the CPU's int32 accumulators bit for bit, and int8
vit_small keeps K1 at 8 launches a dispatch with its plan 49 / 1 / 8.

Detection inference has no kernel: greedy NMS on the card against NMS on
the CPU on identical inputs at the yolov3 shape (exact picks, counts and
gathered rows), and a reduced yolov3's candidates before NMS on the card
against the CPU in f32 within 1e-4 of the largest value.

CenterNet and pose have no kernel: CenterNet's decode on the card picks
what it picks on the CPU on identical heads of five logit values (plateaus
of tied peaks, an image with fewer peaks than picks: ties in index order
on both devices), classes exact, scores and boxes within 1e-6 (one
sigmoid of the same logit on each device); `encode_labels` on the card
with a shared centre cell (the last valid box writes) and a centre on the
edge equals the CPU, masks, sizes and offsets exactly, the gaussians
within 1e-6; the keypoint heatmaps within 1e-6 and their decode exactly;
and reduced models of both families (2 stacks, order 2, width 1/16) in f32
eval mode on the card within 1e-5 of the CPU's largest output.

Segmentation and the GANs have no kernel: the transposed conv on the card
against the CPU within 1e-5 of the largest output; the paired augment on
the same draws (images 1e-4, masks exact); unet_small's train step on the
card in f64 and f32 against the CPU in f64 (`check_step_against_f64`'s
bounds), its f32 eval forward within 1e-5 and the confusion counts equal;
the DCGAN step and both CycleGAN phases on the card in f64 against the CPU
(chip_smoke.py's `gan_step_errors`: 1e-12 and 1e-9); and unet_synthetic
served on the card from its workdir, the masks equal to the predict
step's.

Resilient training: the async save's snapshot of card tensors survives
the in-place updates of the steps after it (equal tensor for tensor), and
K2 launches once per train step across a divergence rollback.

Data parallelism: both kernels launch on their tensors' card from a
thread whose current card is another (two cards or more; skips on one),
and 2 gloo ranks sharing card 0 take one f64 step of the reduced ResNet
equal to the one-process step within chip_smoke.py's DDP_F64_* bounds.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.detection import (make_yolo_eval_step,
                                                 make_yolo_train_step)
from deepvision_tpu_torch.core.optim import build_optimizer
from deepvision_tpu_torch.core.steps import (make_classification_eval_step,
                                             make_classification_train_step)
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.data import device_augment as daug
from deepvision_tpu_torch.data.detection import synthetic_batches
from deepvision_tpu_torch.models import build_model
from deepvision_tpu_torch.models.alexnet import AlexNetV2
from deepvision_tpu_torch.models.common import Dropout
from deepvision_tpu_torch.models.inception import InceptionV1, InceptionV3
from deepvision_tpu_torch.models.mobilenet import MobileNetV1
from deepvision_tpu_torch.models.resnet import BottleneckBlock, ResNet
from deepvision_tpu_torch.models.shufflenet import ShuffleNetV1
from deepvision_tpu_torch.models.vgg import DEPTHS, VGG
from deepvision_tpu_torch.parallel import mesh
from deepvision_tpu_torch.parallel.prefetch import prefetch_to_device
from deepvision_tpu_torch.serve.engine import PredictEngine
from deepvision_tpu_torch.ops import attention as port
from deepvision_tpu_torch.ops import best_iou as k2
from deepvision_tpu_torch.utils.device import resolve_device

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (check_f64_step_errors,  # noqa: E402
                        check_step_against_f64, coarse_heads,
                        f64_step_errors,
                        padded_gt, ragged_gt, ragged_preds,
                        random_boxes, same, train_step_state)

pytestmark = pytest.mark.cuda

# The port's steps update their state in place and donate nothing; jaxlint
# resolves `make_classification_train_step` by name to the JAX package's
# donating one.
# jaxlint: disable-file=DON001
BOUND = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


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


def test_vit_train_and_eval_steps_on_the_card_launch_once_per_block(card):
    """A vit_tiny train step with dropout on the card: one kernel launch
    per block in the forward, none in the backward, a finite loss, every
    parameter updated; the masks come from a CUDA generator and repeat for
    the same (seed, step). Eval launches once per block too."""
    cfg = get_config("vit_tiny")
    cfg = cfg.replace(model_kwargs={**cfg.model_kwargs,
                                    "dropout_rate": 0.1})
    model = build_model(cfg).to("cuda")
    before_w = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = build_optimizer(model.parameters(), cfg.optimizer, cfg.schedule,
                          16, cfg.total_epochs)
    state = TrainState(model, opt, seed=3)
    step = make_classification_train_step(label_smoothing=0.1)
    eval_step = make_classification_eval_step()
    g = torch.Generator().manual_seed(0)
    images = torch.randn(4, 32, 32, 3, generator=g).cuda()
    labels = torch.randint(0, 10, (4,), generator=g).cuda()
    depth = cfg.model_kwargs["depth"]
    before = port.flash_attention.launches
    metrics = step(state, images, labels)
    assert port.flash_attention.launches - before == depth
    assert all(torch.isfinite(v) for v in metrics.values())
    assert state.dropout_generator().device.type == "cuda"
    for n, p in model.named_parameters():
        if not n.endswith("attn.key.bias"):     # its gradient is 0
            assert not torch.equal(p.detach(), before_w[n]), n
    sums = eval_step(state, images, labels, torch.ones(4, device="cuda"))
    assert port.flash_attention.launches - before == 2 * depth
    assert float(sums["count"]) == 4.0 and torch.isfinite(sums["loss"])
    state.step = 0
    with torch.no_grad():
        model.train()
        a = model(images, generator=state.dropout_generator())
        b = model(images, generator=state.dropout_generator())
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_vit_forward_on_the_card_launches_once_per_block(card):
    cfg = get_config("vit_tiny")
    model = build_model(cfg).eval().to("cuda").cast_compute_weights_()
    x = torch.randn(3, 32, 32, 3, device="cuda")
    before = port.flash_attention.launches
    with torch.inference_mode():
        out = model(x)
    assert port.flash_attention.launches - before == cfg.model_kwargs["depth"]
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_registered_operator_launches_the_kernel(card, dtype):
    """`deepvision::flash_attention` called as an operator on CUDA tensors
    launches the kernel once, in the kernel's (B, N, H, D) layout."""
    q, k, v = _qkv((2, 6, 197, 64), dtype, seed=19)
    before = port.flash_attention.launches
    out = torch.ops.deepvision.flash_attention(q, k, v, 0.125)
    assert port.flash_attention.launches == before + 1
    assert out.permute(0, 2, 1, 3).is_contiguous()
    ref = port.flash_attention_reference(q, k, v, scale=0.125)
    assert (out.float() - ref.float()).abs().max().item() <= BOUND[dtype]
    with pytest.raises(TypeError, match="unsupported"):
        torch.ops.deepvision.flash_attention(q.half(), k.half(), v.half(),
                                             0.125)
    with pytest.raises(ValueError, match="unit stride"):
        torch.ops.deepvision.flash_attention(q.transpose(-1, -2), k, v, 0.1)
    assert port.flash_attention.launches == before + 1


def test_exported_vit_program_on_the_card_launches_once_per_block(card):
    """A vit_tiny program exported on the card holds one K1 node a block
    and launches the kernel once for each."""
    from deepvision_tpu_torch.core import export
    cfg = get_config("vit_tiny")
    model = build_model(cfg).eval().cast_compute_weights_().to("cuda")
    program = export.export_program(model, (32, 32, 3), batch_size=3)
    depth = cfg.model_kwargs["depth"]
    assert export.flash_attention_nodes(program) == depth
    x = torch.randn(3, 32, 32, 3, device="cuda")
    before = port.flash_attention.launches
    with torch.inference_mode():
        out = program.module()(x)
        want = model(x)
    assert port.flash_attention.launches - before == 2 * depth
    assert (out - want).abs().max().item() <= 1e-2 * want.abs().max().item()


def test_k1_dispatch_times_each_layer_of_a_call(card):
    """tools/k1_dispatch.py times the wrapper, the operator and the bare
    launch at every bucket, each a launch of the kernel."""
    from deepvision_tpu_torch.tools import k1_dispatch
    before = port.flash_attention.launches
    got = k1_dispatch.measure(repeats=1)
    assert [r["bucket"] for r in got["rows"]] == list(k1_dispatch.BUCKETS)
    for row in got["rows"]:
        assert all(row[f"{name}_ms"] > 0 and row[f"{name}_min_ms"] > 0
                   for name in ("wrapper", "operator", "launch"))
        assert row["device_ms"] > 0
    assert port.flash_attention.launches > before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(2, 3, 9, 16), (4, 6, 197, 64)], ids=str)
def test_kernel_gradients_match_naive_attention(card, shape, dtype):
    """Under autograd the kernel runs the forward (one launch per call)
    and the naive VJP the backward: q, k and v gradients, in the model's
    strided head-split layout, equal plain autograd through
    `naive_attention` within the forward's bounds. Under inference_mode
    the kernel still serves, with no graph."""
    b, h, n, d = shape
    g = torch.Generator().manual_seed(n)
    qkv = [torch.randn((b, n, h * d), generator=g).to("cuda", dtype)
           .view(b, n, h, d).permute(0, 2, 1, 3).requires_grad_(True)
           for _ in range(3)]
    w = torch.randn(shape, generator=g).to("cuda")
    before = port.flash_attention.launches
    out = port.flash_attention(*qkv)
    assert port.flash_attention.launches == before + 1
    (out.float() * w).sum().backward()
    assert port.flash_attention.launches == before + 1
    plain = [t.detach().clone().requires_grad_(True) for t in qkv]
    (port.naive_attention(*plain).float() * w).sum().backward()
    for t, p in zip(qkv, plain):
        assert t.grad.stride() == t.stride() and t.grad.dtype == dtype
        assert (t.grad.float() - p.grad.float()).abs().max().item() \
            <= BOUND[dtype]
    with torch.inference_mode():
        served = port.flash_attention(*(t.detach() for t in qkv))
    assert port.flash_attention.launches == before + 2
    assert served.grad_fn is None and torch.isfinite(served.float()).all()


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
    opt = build_optimizer(model.parameters(), cfg.optimizer, cfg.schedule,
                          10, cfg.total_epochs)
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


# -- the ResNet slice: prefetcher, device augment, reduced ResNet ------------

def _host_batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 256, (4, 36, 36, 3)).astype(np.uint8),
             rs.randint(0, 10, 4).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("size", [1, 3])
def test_prefetcher_stages_pinned_on_a_side_stream(card, size):
    host = _host_batches(5)
    staged = prefetch_to_device(iter(host), size, card)
    got = []
    for batch in staged:
        assert all(t.device.type == "cuda" for t in batch)
        got.append([t.cpu().numpy() for t in batch])
    staged.close()
    assert staged._stream is not None
    assert staged._stream != torch.cuda.current_stream()
    buffers = [buf for free in staged._pool._free.values()
               for buf, _ in free]
    assert buffers and all(buf.is_pinned() for buf in buffers)
    for g, w in zip(got, host):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert len(got) == len(host)
    assert staged.bytes_staged_total == sum(a.nbytes + b.nbytes
                                            for a, b in host)


def test_prefetcher_reuses_no_buffer_early_under_a_slow_consumer(card):
    """The consumer reads each batch only after the producer has staged
    the next ones (from the same pinned shapes): every batch still holds
    its own host values."""
    host = _host_batches(8, seed=1)
    staged = prefetch_to_device(iter(host), 4, card)
    kept = []
    for batch in staged:
        time.sleep(0.05)
        kept.append(batch)
    staged.close()
    for batch, (images, labels) in zip(kept, host):
        np.testing.assert_array_equal(batch[0].cpu().numpy(), images)
        np.testing.assert_array_equal(batch[1].cpu().numpy(), labels)


def test_device_augment_on_the_card_matches_the_cpu(card):
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (8, 40, 40, 3), generator=gen,
                           dtype=torch.uint8)
    draws = daug.draw_train_params(8, 40, 40, 32, gen)
    kw = dict(compute_dtype=torch.float32)
    card_out = daug.apply_train_augment(images.cuda(), draws.to("cuda"), 32,
                                        **kw).cpu()
    cpu_out = daug.apply_train_augment(images, draws, 32, **kw)
    assert (card_out - cpu_out).abs().max().item() <= 1e-4
    evaluate = daug.make_eval_augment(32, **kw)
    assert (evaluate(images.cuda()).cpu() - evaluate(images)).abs().max() \
        .item() <= 1e-4
    # draws on a card generator stay on the card and in their ranges
    g = torch.Generator(device="cuda").manual_seed(1)
    d = daug.draw_train_params(8, 40, 40, 32, g)
    assert d.tops.device.type == "cuda"
    assert int(d.tops.max()) <= 8 and int(d.lefts.max()) <= 8


def _reduced_resnet():
    model = ResNet((1, 1, 1, 1), BottleneckBlock, num_classes=10, width=8,
                   dtype=torch.float32,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():     # every gradient flows: no zero BN scale
        for name, p in model.named_parameters():
            if "BatchNorm" in name and name.endswith("weight"):
                p.uniform_(0.5, 1.5,
                           generator=torch.Generator().manual_seed(1))
    return model


def test_reduced_resnet_forward_on_the_card_matches_the_cpu(card):
    model = _reduced_resnet().eval()
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x)
        got = model.to("cuda")(x.cuda()).cpu()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_reduced_resnet_train_step_on_the_card_matches_the_cpu(card):
    cfg = get_config("resnet50_tpu")
    images, labels = (np.random.RandomState(3).randn(8, 32, 32, 3)
                      .astype(np.float32),
                      np.arange(8, dtype=np.int32))
    out = {}
    for device in ("cpu", "cuda"):
        model = _reduced_resnet().to(device)
        opt = build_optimizer(model.parameters(), cfg.optimizer,
                              cfg.schedule, 10, 1)
        state = TrainState(model, opt, ema_decay=0.9)
        step = make_classification_train_step(
            label_smoothing=0.1, compute_dtype=torch.float32)
        m = step(state, torch.from_numpy(images).to(device),
                 torch.from_numpy(labels).to(device))
        state.update_ema()
        out[device] = (float(m["loss"]),
                       {n: p.grad.cpu() for n, p in model.named_parameters()},
                       [e.cpu() for e in state.ema])
    (cpu_loss, cpu_grads, cpu_ema), (loss, grads, ema) = out["cpu"], \
        out["cuda"]
    assert loss == pytest.approx(cpu_loss, rel=1e-5)
    for name, g in cpu_grads.items():
        assert (grads[name] - g).abs().max().item() \
            <= 1e-4 * g.abs().max().item(), name
    for e, w in zip(ema, cpu_ema):
        assert (e - w).abs().max().item() <= 1e-5 * max(w.abs().max(), 1)


# -- the classification zoo ---------------------------------------------------

# config name -> (reduced f32 model of its family, image size)
ZOO = {
    "alexnet2": (lambda g: AlexNetV2(10, torch.float32, image_size=67,
                                     generator=g), 67),
    "vgg16": (lambda g: VGG(DEPTHS["vgg16"], 10, torch.float32,
                            image_size=32, generator=g), 32),
    "inception_v1": (lambda g: InceptionV1(10, dtype=torch.float32,
                                           image_size=96, generator=g), 96),
    "inception_v3": (lambda g: InceptionV3(10, dtype=torch.float32,
                                           image_size=107, generator=g),
                     107),
    "mobilenet_v1": (lambda g: MobileNetV1(10, 0.25, torch.float32,
                                           generator=g), 32),
    "shufflenet_v1": (lambda g: ShuffleNetV1(10, dtype=torch.float32,
                                             generator=g), 32),
}


def _zoo_model(name: str):
    ctor, size = ZOO[name]
    model = ctor(torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model, size


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_forward_on_the_card_matches_the_cpu(card, name):
    model, size = _zoo_model(name)
    model.eval()
    x = torch.randn(4, size, size, 3,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x)
        got = model.to("cuda")(x.cuda()).cpu()
    assert got.shape == want.shape == (4, 10)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_train_step_on_the_card_matches_the_cpu(card, name):
    model, size = _zoo_model(name)
    batch = (np.random.RandomState(3).randn(4, size, size, 3)
             .astype(np.float32), np.arange(4, dtype=np.int32))
    check_step_against_f64(get_config(name), model, batch, name,
                           f"4 images at {size} px")


def test_engine_serves_mobilenet_v1_on_the_card(card):
    engine = PredictEngine.from_config("mobilenet_v1", device="cuda",
                                       buckets=(1, 8), verbose=False)
    cpu = PredictEngine.from_config("mobilenet_v1", device="cpu",
                                    buckets=(3,), verbose=False)
    x = np.random.RandomState(4).randn(3, 224, 224, 3).astype(np.float32)
    got, ref = engine.predict(x), engine.reference(x)
    want = cpu.reference(x)
    scale = np.abs(want).max()
    assert got.shape == (3, 1000) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 5e-2 * np.abs(ref).max()
    assert np.abs(ref - want).max() <= 5e-2 * scale


# -- detection inference: NMS on the card -----------------------------------

YOLO_N = 3 * (52 * 52 + 26 * 26 + 13 * 13)      # yolov3's 10647 at 416 px


def _nms_inputs(grid: bool, seed: int):
    """(16, 10647) candidates of 80 classes, the yolov3 predict shape: on a
    1/8 box grid and 1/1024 score grid (every pick decided with a margin:
    IoUs are ratios a/u with u <= 128, scores tie exactly or differ by
    1/1024), or continuous."""
    g = torch.Generator().manual_seed(seed)
    shape = (16, YOLO_N)
    if grid:
        lo = torch.randint(0, 8, (*shape, 2), generator=g)
        hi = torch.clamp(lo + torch.randint(0, 5, (*shape, 2), generator=g),
                         max=8)
        boxes = torch.cat([lo, hi], -1).float() / 8.0
        scores = torch.randint(0, 1025, shape, generator=g).float() / 1024.0
    else:
        boxes = random_boxes(*shape, g)
        scores = torch.rand(shape, generator=g)
    return boxes, scores, torch.rand(*shape, 80, generator=g)


def _pick_margins(boxes, picks, iou_thresh):
    """Smallest |IoU - iou_thresh| between each valid pick and every
    candidate of its image, and smallest nonzero gap between two picked
    scores, in f64."""
    from deepvision_tpu_torch.ops.boxes import broadcast_iou
    iou_gap, score_gap = float("inf"), float("inf")
    for i in range(boxes.shape[0]):
        n = int(picks[3][i])
        iou = broadcast_iou(picks[0][i, :n].double(), boxes[i].double())
        iou_gap = min(iou_gap, (iou - iou_thresh).abs().min().item())
        s = picks[1][i, :n].double()
        gap = (s[:, None] - s[None, :]).abs()
        if (gap > 0).any():
            score_gap = min(score_gap, gap[gap > 0].min().item())
    return iou_gap, score_gap


@pytest.mark.parametrize("grid", [True, False], ids=["grid", "continuous"])
def test_nms_on_the_card_picks_what_the_cpu_picks(card, grid):
    """Identical inputs at the yolov3 shape (B 16, N 10647, C 80, D 100):
    the card's picks, scores, class probabilities and counts equal the
    CPU's exactly. On the grid inputs every pick has a margin (IoU 1e-6
    from the threshold, scores tied or 1e-7 apart); on the continuous ones
    the two devices run the same IEEE f32 operations, so they agree
    without one."""
    from deepvision_tpu_torch.ops.nms import batched_nms
    boxes, scores, classes = _nms_inputs(grid, seed=3)
    # on the grid an IoU of exactly 1/2 occurs; no a/u with u <= 128 lies
    # within 1.5e-5 of 255/512
    iou_thresh = 255 / 512 if grid else 0.5
    kw = dict(iou_thresh=iou_thresh, score_thresh=0.05, max_detection=100)
    cpu = batched_nms(boxes, scores, classes, **kw)
    got = batched_nms(boxes.cuda(), scores.cuda(), classes.cuda(), **kw)
    assert all(t.device.type == "cuda" for t in got)
    for g, c in zip(got, cpu):
        assert torch.equal(g.cpu(), c)
    assert int(cpu[3].min()) > 0
    if grid:
        iou_gap, score_gap = _pick_margins(boxes, cpu, iou_thresh)
        assert iou_gap >= 1e-6 and score_gap >= 1e-7


def test_predict_step_on_the_card_matches_the_cpu(card):
    """A reduced yolov3 (width 0.25, stages (1, 1, 2, 2, 1), 80 classes)
    at 416 px in f32: the candidates before NMS on the card within 1e-4 of
    the CPU's (cuDNN's conv sums in another order), and NMS on the card's
    candidates equal to NMS on the same candidates on the CPU."""
    from deepvision_tpu_torch.core.detection import predict_candidates
    from deepvision_tpu_torch.models.yolo import YoloV3
    from deepvision_tpu_torch.ops.nms import batched_nms
    model = YoloV3(num_classes=80, width_mult=0.25,
                   stage_blocks=(1, 1, 2, 2, 1), dtype=torch.float32,
                   generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 416, 416, 3)
                         .astype(np.float32) * 2 - 1)
    with torch.inference_mode():
        want = predict_candidates(model, x, torch.float32)
        got = predict_candidates(model.cuda(), x.cuda(), torch.float32)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.float32
            assert (g.cpu() - w).abs().max().item() <= 1e-4 * max(
                1.0, w.abs().max().item())
        kw = dict(iou_thresh=0.5, score_thresh=0.05, max_detection=100)
        card_nms = batched_nms(*got, **kw)
        cpu_nms = batched_nms(*(t.cpu() for t in got), **kw)
    for g, c in zip(card_nms, cpu_nms):
        assert torch.equal(g.cpu(), c)


# -- CenterNet and pose --------------------------------------------------------

@pytest.mark.parametrize("g,c,k", [(64, 80, 100), (8, 3, 100), (6, 5, 7)])
def test_centernet_decode_on_the_card_picks_what_the_cpu_picks(card, g, c,
                                                               k):
    from deepvision_tpu_torch.ops.centernet import decode
    heads = coarse_heads(4, g, c, seed=g + c)
    cpu = decode(heads, max_detections=k)
    got = decode({n: v.cuda() for n, v in heads.items()}, max_detections=k)
    assert all(t.device.type == "cuda" for t in got)
    assert torch.equal(got[2].cpu(), cpu[2])
    assert (got[1].cpu() - cpu[1]).abs().max().item() <= 1e-6
    assert (got[0].cpu() - cpu[0]).abs().max().item() <= 1e-6 * g
    assert (cpu[1][1] == 0).any() == (g * g * c > k > c)


def test_centernet_encode_labels_on_the_card_equals_the_cpu(card):
    from deepvision_tpu_torch.ops.centernet import encode_labels
    rs = np.random.RandomState(2)
    xy1 = rs.uniform(-0.05, 0.8, (3, 100, 2))
    boxes = np.concatenate([xy1, xy1 + rs.uniform(0.02, 0.4, (3, 100, 2))],
                           -1).astype(np.float32)
    boxes[0, :4] = [[0.30, 0.30, 0.40, 0.42], [0.31, 0.33, 0.39, 0.45],
                    [0.32, 0.31, 0.38, 0.40], [0.29, 0.32, 0.41, 0.41]]
    boxes[0, 4] = [0.90, 0.90, 1.10, 1.10]     # centre exactly 1.0: dropped
    classes = rs.randint(-1, 81, (3, 100)).astype(np.int32)
    valid = (rs.rand(3, 100) < 0.3).astype(np.float32)
    valid[0, :5] = [1, 1, 0, 1, 1]
    args = [torch.from_numpy(a) for a in (boxes, classes, valid)]
    cpu = encode_labels(*args, 64, 80)
    got = encode_labels(*(a.cuda() for a in args), 64, 80)
    for k in ("mask", "size", "offset"):
        assert torch.equal(got[k].cpu(), cpu[k]), k
    assert (got["heatmap"].cpu() - cpu["heatmap"]).abs().max() <= 1e-6
    assert cpu["mask"][0].sum() < valid[0].sum()   # shared cells, an edge


def test_keypoint_heatmaps_and_decode_on_the_card_equal_the_cpu(card):
    from deepvision_tpu_torch.ops.heatmap import (decode_keypoints,
                                                  render_gaussian_heatmaps)
    rs = np.random.RandomState(3)
    kp = [torch.from_numpy(rs.uniform(-0.2, 1.2, (8, 16))
                           .astype(np.float32)) for _ in range(2)]
    vis = torch.from_numpy((rs.rand(8, 16) > 0.2).astype(np.float32) * 2)
    cpu = render_gaussian_heatmaps(*kp, vis, 64, 64)
    got = render_gaussian_heatmaps(*(t.cuda() for t in (*kp, vis)), 64, 64)
    assert (got.cpu() - cpu).abs().max().item() <= 1e-6
    for g, c in zip(decode_keypoints(got), decode_keypoints(cpu)):
        assert torch.equal(g.cpu(), c)


@pytest.mark.parametrize("name", ["centernet", "hourglass104"])
def test_reduced_centernet_and_hourglass_forward_on_the_card(card, name):
    from deepvision_tpu_torch.models.centernet import ObjectsAsPoints
    from deepvision_tpu_torch.models.hourglass import StackedHourglass
    ctor = ObjectsAsPoints if name == "centernet" else StackedHourglass
    model = ctor(num_stack=2, order=2, width_mult=1 / 16,
                 dtype=torch.float32,
                 generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 64, 64, 3)
                         .astype(np.float32) * 2 - 1)
    with torch.inference_mode():
        want = model(x)
        got = model.cuda()(x.cuda())
    flat = lambda t: [v for s in t for v in (s.values()  # noqa: E731
                                              if isinstance(s, dict) else [s])]
    for g, w in zip(flat(got), flat(want)):
        assert g.shape == w.shape
        assert (g.cpu() - w).abs().max().item() <= 1e-5 * max(
            1.0, w.abs().max().item())


# -- data parallelism ---------------------------------------------------------

def test_kernels_launch_on_their_tensors_card_whatever_card_is_current(card):
    """K1 and K2 on tensors of the last card, called from a thread whose
    current card is 0: each wrapper launches on its tensors' card (the
    launch runs under `torch.cuda.device(tensor.device)`), once, and
    agrees with its plain version. Needs two cards or more: skips on one
    (a data-parallel rank drives a card other than 0 only there)."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two cards or more")
    dev = torch.device("cuda", count - 1)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 6, 197, 64), generator=gen)
               .to(dev, torch.bfloat16) for _ in range(3))
    preds = [random_boxes(4, n, gen).to(dev) for n in (8112, 2028, 507)]
    gt = padded_gt(4, 100, gen).to(dev)
    out = {}

    def launch():
        try:
            torch.cuda.set_device(0)
            before = (port.flash_attention.launches, k2.best_iou.launches)
            out["attention"] = port.flash_attention(q, k, v)
            out["iou"] = k2.best_iou(preds, gt)
            torch.cuda.synchronize(dev)
            out["launches"] = (port.flash_attention.launches - before[0],
                               k2.best_iou.launches - before[1])
            out["current"] = torch.cuda.current_device()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e

    t = threading.Thread(target=launch)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    assert out["launches"] == (1, 1) and out["current"] == 0
    assert out["attention"].device == dev
    ref = port.flash_attention_reference(q, k, v)
    assert (out["attention"].float() - ref.float()).abs().max().item() \
        <= BOUND[torch.bfloat16]
    for got, want in zip(out["iou"], k2.best_iou_reference(preds, gt)):
        assert got.device == dev and same(got, want)


def _gloo_rank_on_card_0(out):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = mesh.rank(), mesh.world_size()
    rows = [mesh.shard_rows(a, rank, world) for a in _f64_batch()]
    torch.save(train_step_state(get_config("resnet50_tpu"),
                                _reduced_resnet(), rows,
                                resolve_device("cuda"), torch.float64),
               os.path.join(out, f"rank{rank}.pt"))


def _f64_batch():
    return (np.random.RandomState(3).randn(4, 32, 32, 3).astype(np.float32),
            np.arange(4, dtype=np.int32))


def test_two_gloo_ranks_on_one_card_match_the_one_process_f64_step(
        card, tmp_path):
    """One f64 step of the reduced ResNet (resnet50_tpu's recipe) by 2
    ranks over gloo, both on card 0, at global batch 4, against the
    one-process step on the same 4 images on the card, within
    chip_smoke.py's DDP_F64_* bounds (phase 11b at full size)."""
    mesh.spawn_ranks(_gloo_rank_on_card_0, (str(tmp_path),), world=2,
                     same_card=True, timeout=300)
    model = _reduced_resnet()
    one = train_step_state(get_config("resnet50_tpu"), model, _f64_batch(),
                           torch.device("cuda"), torch.float64)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
             for r in range(2)]
    err = f64_step_errors(one, ranks, dict(model.named_parameters()))
    check_f64_step_errors(err)


# -- segmentation and the GANs ------------------------------------------------

@pytest.mark.parametrize("kernel,stride,size", [(5, 1, 7), (5, 2, 7),
                                                (3, 2, 9), (3, 2, 64)])
def test_conv_transpose_on_the_card_matches_the_cpu(card, kernel, stride,
                                                    size):
    from deepvision_tpu_torch.models.common import ConvTranspose
    g = torch.Generator().manual_seed(size)
    conv = ConvTranspose(8, 4, kernel, stride, use_bias=True)
    with torch.no_grad():
        conv.weight.normal_(generator=g)
        conv.bias.normal_(generator=g)
    x = torch.randn(2, 8, size, size + 1, generator=g)
    with torch.no_grad():
        want = conv(x)
        got = conv.cuda()(x.cuda()).cpu()
    assert got.shape == want.shape == (2, 4, size * stride,
                                       (size + 1) * stride)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_paired_augment_on_the_card_matches_the_cpu(card):
    """The same draws on both devices: images within 1e-4, masks exact."""
    rs = np.random.RandomState(0)
    images = torch.from_numpy(rs.randint(0, 256, (4, 40, 40, 3))
                              .astype(np.uint8))
    masks = torch.from_numpy(rs.randint(0, 6, (4, 40, 40)).astype(np.uint8))
    draws = daug.draw_train_params(4, 40, 40, 32,
                                   torch.Generator().manual_seed(1))
    kw = dict(mean=(0.5,) * 3, std=(0.5,) * 3, compute_dtype=torch.float32)
    want = daug.apply_paired_train_augment(images, masks, draws, 32, **kw)
    got = daug.apply_paired_train_augment(images.cuda(), masks.cuda(),
                                          draws.to("cuda"), 32, **kw)
    assert (got[0].cpu() - want[0]).abs().max().item() <= 1e-4
    assert torch.equal(got[1].cpu(), want[1])


def test_unet_train_step_on_the_card_matches_the_cpu(card):
    """unet_small (the unet_synthetic model) one step on 2 images at 32
    px, on the card in f64 and f32 against the CPU in f64
    (`check_step_against_f64`: 1e-12 / 1e-9 in f64, 2e-4 / 1e-1 in f32);
    the eval forward in f32 within 1e-5, and the confusion counts of the
    eval step equal."""
    from deepvision_tpu_torch.core.metrics import confusion_matrix
    from deepvision_tpu_torch.core.segment import make_segmentation_train_step
    cfg = get_config("unet_synthetic")
    model = build_model(cfg)
    rs = np.random.RandomState(2)
    batch = (rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
             rs.randint(0, 6, (2, 32, 32)).astype(np.int32))
    check_step_against_f64(
        cfg, model, batch, "unet_small", "2 images at 32 px",
        make_step=lambda dt: make_segmentation_train_step(compute_dtype=dt))
    x, masks = (torch.from_numpy(a) for a in batch)
    with torch.inference_mode():
        want = model.eval()(x)
        got = model.cuda()(x.cuda()).cpu()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal(confusion_matrix(got.argmax(-1).cuda(), masks.cuda(),
                                        6).cpu(),
                       confusion_matrix(got.argmax(-1), masks, 6))


def test_gan_steps_on_the_card_match_the_cpu_in_f64(card):
    """One DCGAN step (the same noise, dropout off) and both CycleGAN
    phases (1 block, 32 px) on the card in f64 against the CPU in f64:
    losses 1e-12 relative, gradients and BatchNorm statistics 1e-9
    (chip_smoke.py's `gan_step_errors`)."""
    from chip_smoke import cyclegan_step_runs, dcgan_step_run, gan_step_errors
    gan_step_errors(dcgan_step_run(), "dcgan")
    for run, what in zip(cyclegan_step_runs(32, 1), ("generator phase",
                                                     "discriminator phase")):
        gan_step_errors(run, what)


def test_engine_serves_segmentation_masks_on_the_card(card, tmp_path):
    """unet_synthetic trained one step on the card, served from its
    workdir on the card: provenance `checkpoint`, int32 masks equal to
    the predict step's on the same weights."""
    from deepvision_tpu_torch.cli import run_segmentation
    from deepvision_tpu_torch.core.segment import \
        make_segmentation_predict_step
    trainer, _ = run_segmentation("UNet", ["unet_synthetic"], [
        "-m", "unet_synthetic", "--synthetic", "--epochs", "1",
        "--steps-per-epoch", "1", "--batch-size", "2", "--workdir",
        str(tmp_path)])
    engine = PredictEngine.from_config("unet_synthetic", device="cuda",
                                       buckets=(1, 4), workdir=str(tmp_path),
                                       verbose=False)
    assert engine.provenance["weights"] == "checkpoint"
    x = np.random.RandomState(3).uniform(-1, 1, (4, 64, 64, 3)).astype(
        np.float32)
    want = make_segmentation_predict_step(compute_dtype=torch.float32)(
        trainer.state, torch.from_numpy(x).cuda()).cpu().numpy()
    got = engine.predict(x)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# -- resilient training: the async snapshot and the rollback -----------------

def test_the_snapshot_of_card_tensors_survives_in_place_updates(card,
                                                                 tmp_path):
    """save() copies card tensors into pinned buffers without blocking and
    returns; train steps that update every tensor in place right after it
    (on the same stream) must not reach the checkpoint. A second save
    reuses the pinned buffers."""
    from deepvision_tpu_torch.core import integrity
    from deepvision_tpu_torch.core.checkpoint import CheckpointManager
    model = _reduced_resnet().to("cuda")
    opt = build_optimizer(model.parameters(),
                          get_config("resnet50_tpu").optimizer,
                          get_config("resnet50_tpu").schedule, 10, 1)
    state = TrainState(model, opt)
    step = make_classification_train_step(compute_dtype=torch.float32)
    x = torch.randn(4, 32, 32, 3, device="cuda")
    y = torch.randint(0, 10, (4,), device="cuda", dtype=torch.int32)
    step(state, x, y)
    mgr = CheckpointManager(str(tmp_path), keep=2, keep_best=False)
    for epoch in (1, 2):
        want = {k: v.detach().cpu().clone() for k, v in integrity.flatten(
            state.state_dict()).items() if torch.is_tensor(v)}
        mgr.save(epoch, state.state_dict())
        for _ in range(3):
            step(state, x, y)
        mgr.flush()
        got, _, restored = mgr.restore(epoch, verify="strict")
        assert restored == epoch
        for k, v in integrity.flatten(got).items():
            if torch.is_tensor(v):
                assert torch.equal(v, want[k]), (epoch, k)
    mgr.close()


def test_the_k2_count_across_a_rollback(card, tmp_path, monkeypatch):
    """yolov3_digits trained 2 epochs of 2 steps on the card with the NaN
    fault at epoch 2's first batch and one recovery: K2 launches once per
    train step (the diverged epoch's and the retried epoch's included) and
    per eval batch, and the run ends at the right step and LR scale."""
    from deepvision_tpu_torch.cli import run_detection
    monkeypatch.setenv("DEEPVISION_FAULT_NAN_STEP", "2")
    monkeypatch.setenv("DEEPVISION_IO_RETRY_DELAY", "0.01")
    before = k2.best_iou.launches
    trainer, _ = run_detection("YOLO", ["yolov3_digits"], [
        "-m", "yolov3_digits", "--synthetic", "--image-size", "64",
        "--batch-size", "2", "--steps-per-epoch", "2", "--epochs", "2",
        "--recover-on-divergence", "1", "--workdir", str(tmp_path)])
    hist = trainer.logger.history
    assert hist["resilience_divergence_recoveries"]["value"] == [1.0]
    assert hist["epoch_train_loss"]["epochs"] == [1, 2, 2]
    assert trainer.state.step == 4
    assert k2.best_iou.launches - before == 6 + 2 * 2


# -- the input path: nvJPEG and the resample kernel --------------------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "jpeg")
# nvJPEG against the fixtures' PIL goldens (= libjpeg's INTEGER_ACCURATE):
# another IDCT and chroma upsampling, at most 4 levels measured on the
# H100 (chip_smoke.py P18_DECODE_TOL)
DECODE_TOL = 6


def test_nvjpeg_decodes_the_fixtures_near_libjpeg(card):
    """Every committed fixture (4:4:4, 4:2:0, 4:2:2 at an odd size,
    grayscale, progressive, restart markers) decoded on the card, alone
    and as one batch (the routes differ: the batched backend takes the
    sequential streams, the default one the progressive), within
    DECODE_TOL of its PIL golden; never through PIL."""
    from deepvision_tpu_torch.data import jpeg
    names = sorted(f[:-4] for f in os.listdir(FIXTURES)
                   if f.endswith(".jpg"))
    datas = [open(os.path.join(FIXTURES, n + ".jpg"), "rb").read()
             for n in names]
    jpeg.zero_stats()
    batch = jpeg.decode_batch(datas, card)
    for i, (name, data) in enumerate(zip(names, datas)):
        want = np.load(os.path.join(FIXTURES, name + ".pil.npy"))
        alone = jpeg.decode_batch([data], card).image(0).cpu().numpy()
        together = batch.image(i).cpu().numpy()
        for got in (alone, together):
            assert got.shape == want.shape, name
            assert np.abs(got.astype(int) - want).max() <= DECODE_TOL, name
    assert jpeg.stats["cpu_images"] == 0
    assert jpeg.images_decoded() == 2 * len(names)


def test_flat_loader_on_the_card_refuses_a_png(card, tmp_path):
    """A flat layout of the committed JPEG fixtures loads on the card
    through nvJPEG; one PNG among them (named .JPEG, as ILSVRC2012's
    n02105855_2933 is) is refused by name when the loader is built."""
    import torch_records_fixtures as fx
    from deepvision_tpu_torch.data import jpeg
    from deepvision_tpu_torch.data.imagenet_flat import (FlatImageNet,
                                                         NotJpegError)
    names = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".jpg"))
    for i, name in enumerate(names):
        (tmp_path / f"n0{1 + i % 2}_{i}.JPEG").write_bytes(
            open(os.path.join(FIXTURES, name), "rb").read())
    synsets = {"n01": 0, "n02": 1}
    kw = dict(batch_size=2, training=False, image_size=32, device=card)
    jpeg.zero_stats()
    batches = list(FlatImageNet(str(tmp_path), synsets, **kw))
    assert len(batches) == len(names) // 2
    assert all(im.is_cuda and im.shape == (2, 32, 32, 3)
               and bool(torch.isfinite(im).all()) for im, _ in batches)
    assert jpeg.stats["cpu_images"] == 0
    (tmp_path / "n01_99.JPEG").write_bytes(fx.png(
        np.zeros((8, 8, 3), np.uint8)))
    with pytest.raises(NotJpegError, match=r"1 file\(s\) .*: n01_99\.JPEG"):
        FlatImageNet(str(tmp_path), synsets, **kw)


@pytest.mark.parametrize("mode", ["bicubic", "bilinear", "bilinear_aa"])
def test_resample_kernel_matches_plain_version(card, mode):
    """One launch for a batch of mixed sizes, crops, windows and flips:
    f32 within 1e-3 on the [0, 255] scale of the plain version on the
    same decoded pixels, uint8 within a level (a rounding tie)."""
    from deepvision_tpu_torch.data import jpeg, util
    datas = [open(os.path.join(FIXTURES, n), "rb").read()
             for n in sorted(os.listdir(FIXTURES)) if n.endswith(".jpg")]
    decoded = jpeg.decode_batch(datas, card)
    plans = []
    for i, (h, w) in enumerate(decoded.shapes):
        plans.append(util.Plan((i % 3, i % 2, h - 3, w - 2),
                               (40 + i, 44), (i % 4, 2), bool(i % 2)))
    host = [decoded.image(i).cpu() for i in range(len(datas))]
    for how in (util.UINT8, util.Emit(uint8=False, clip=False, div=1.0),
                util.normalized((0.485, 0.456, 0.406),
                                (0.229, 0.224, 0.225))):
        before = jpeg.stats["resample_launches"]
        got = jpeg.resample_batch(decoded, plans, (36, 40), mode, how)
        assert jpeg.stats["resample_launches"] == before + 1
        want = util.resample(host, plans, (36, 40), mode, how)
        err = float((got.cpu().float() - want.float()).abs().max())
        assert err <= (1.0 if how.uint8 else 1e-3), (how, err)


# -- the dataset builders' re-encode on the card (slice 16) ------------------

REENCODE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "reencode")
REENCODED = ["gray.jpg", "gray_png.png", "rgb_png.png", "rgba_png.png",
             "palette_png.png"]


def _nvjpeg(data, device):
    from deepvision_tpu_torch.data import jpeg
    return jpeg.decode_batch([data], device).image(0).cpu().numpy().astype(
        np.int16)


@pytest.mark.parametrize("name", REENCODED)
def test_reencode_on_the_card_is_within_the_bound_of_pils(card, name):
    """A gray JPEG or an 8-bit PNG re-encoded by nvJPEG (q95, 4:2:0)
    against PIL's re-encode of the same source (`<name>.pil95.jpg`), both
    decoded by nvJPEG: within chip_smoke's measured bound."""
    from chip_smoke import P18_REENCODE_MAX, P18_REENCODE_MEAN
    from deepvision_tpu_torch.data import jpeg
    from deepvision_tpu_torch.datasets import images
    path = os.path.join(REENCODE, name)
    placeholder, w, h = images.load(path, "cuda")
    assert isinstance(placeholder, images.Reencode)
    (ex,) = images.finish([{"image/encoded": placeholder}], card)
    ours = ex["image/encoded"].values[0]
    assert jpeg.extract_jpeg_shape(ours) == (h, w, 3)
    pil = open(os.path.join(REENCODE, name.rsplit(".", 1)[0]
                            + ".pil95.jpg"), "rb").read()
    diff = np.abs(_nvjpeg(ours, card) - _nvjpeg(pil, card))
    assert diff.max() <= P18_REENCODE_MAX
    assert diff.mean() <= P18_REENCODE_MEAN


@pytest.mark.parametrize("name", [n for n in REENCODED if n.endswith(".png")])
def test_png_reader_equals_its_cpu_decode(card, name):
    """The PNG reader's pixels, uploaded to the card, equal PIL's
    `convert("RGB")` of the source (the committed `<name>.rgb.npy`)."""
    from deepvision_tpu_torch.data.png import read_png
    data = open(os.path.join(REENCODE, name), "rb").read()
    want = np.load(os.path.join(REENCODE, name.rsplit(".", 1)[0]
                                + ".rgb.npy"))
    got = torch.from_numpy(read_png(data)).to(card)
    assert torch.equal(got.cpu(), torch.from_numpy(want))


def test_cmyk_jpeg_is_refused_on_the_card(card):
    """nvJPEG decodes no CMYK JPEG to RGB: the builders refuse it by name
    before the decoder sees it."""
    from deepvision_tpu_torch.datasets import images
    with pytest.raises(images.UnsupportedImageError,
                       match=r"cmyk\.jpg: a 4-component \(CMYK or YCCK\)"):
        images.load(os.path.join(REENCODE, "cmyk.jpg"), "cuda")


def _records(path):
    """Each record's features as {key: (kind, list or bytes of values)}."""
    from deepvision_tpu_torch.data import records
    return [{k: (f.kind, list(f.values) if f.kind == "bytes"
                 else f.values.tobytes())
             for k, f in records.parse_example(r).items()}
            for r in records.read_records(path)]


def test_builds_on_the_card_equal_the_cpu_builds(card, tmp_path):
    """The VOC builder on the card equals its CPU build feature for
    feature (VOC copies its JPEGs); the ImageNet builder over three-
    component JPEGs, a gray JPEG and a PNG equals its CPU build but for
    the re-encoded images' bytes, which stay within the bound."""
    pytest.importorskip("PIL", reason="the CPU build re-encodes with PIL")
    from chip_smoke import P18_REENCODE_MAX, P18_REENCODE_MEAN
    from deepvision_tpu_torch.datasets import imagenet, voc
    jpgs = [open(os.path.join(FIXTURES, n), "rb").read()
            for n in sorted(os.listdir(FIXTURES)) if n.endswith(".jpg")]
    devkit = tmp_path / "VOCdevkit" / "VOC2007"
    for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (devkit / d).mkdir(parents=True)
    from deepvision_tpu_torch.data.jpeg import extract_jpeg_shape
    for i, data in enumerate(jpgs):
        h, w, _ = extract_jpeg_shape(data)
        (devkit / "JPEGImages" / f"{i:06d}.jpg").write_bytes(data)
        (devkit / "Annotations" / f"{i:06d}.xml").write_text(
            f"<annotation><filename>{i:06d}.jpg</filename><size><width>{w}"
            f"</width><height>{h}</height><depth>3</depth></size><object>"
            f"<name>dog</name><bndbox><xmin>1</xmin><ymin>2</ymin><xmax>"
            f"{w - 1}</xmax><ymax>{h}</ymax></bndbox></object>"
            f"</annotation>")
    (devkit / "ImageSets" / "Main" / "train.txt").write_text(
        "".join(f"{i:06d}\n" for i in range(len(jpgs))))
    for dev in ("cuda", "cpu"):
        voc.convert(str(devkit), str(tmp_path / f"voc_{dev}"), 2,
                    splits=("train",), device=dev, num_workers=1)
    for name in sorted(os.listdir(tmp_path / "voc_cpu")):
        assert _records(str(tmp_path / "voc_cuda" / name)) == _records(
            str(tmp_path / "voc_cpu" / name))
    train = tmp_path / "train" / "n01440764"
    train.mkdir(parents=True)
    sources = jpgs + [open(os.path.join(REENCODE, n), "rb").read()
                      for n in ("gray.jpg", "rgb_png.png")]
    for i, data in enumerate(sources):
        (train / f"n01440764_{i}.JPEG").write_bytes(data)
    (tmp_path / "synsets.txt").write_text("n01440764\n")
    (tmp_path / "meta.txt").write_text("n01440764\ttench\n")
    for dev in ("cuda", "cpu"):
        imagenet.main(["--train_directory", str(tmp_path / "train"),
                       "--validation_directory", str(tmp_path / "none"),
                       "--output_directory", str(tmp_path / f"in_{dev}"),
                       "--labels_file", str(tmp_path / "synsets.txt"),
                       "--imagenet_metadata_file", str(tmp_path / "meta.txt"),
                       "--train_shards", "2", "--num_workers", "1",
                       "--device", dev])
    reencoded = 0
    for name in sorted(os.listdir(tmp_path / "in_cpu")):
        got = _records(str(tmp_path / "in_cuda" / name))
        want = _records(str(tmp_path / "in_cpu" / name))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            a, b = g.pop("image/encoded"), w.pop("image/encoded")
            assert g == w
            if a != b:
                reencoded += 1
                diff = np.abs(_nvjpeg(a[1][0], card)
                              - _nvjpeg(b[1][0], card))
                assert diff.max() <= P18_REENCODE_MAX
                assert diff.mean() <= P18_REENCODE_MEAN
    assert reencoded == 3      # the two gray JPEGs and the PNG


# -- int8 serving (ops/quant.py) ----------------------------------------------

def _int8(rs, *shape):
    return torch.from_numpy(rs.randint(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("m,k,n", [(1, 25, 6), (17, 27, 6), (64, 147, 64),
                                   (197, 384, 1152), (8, 120, 84)])
def test_int8_matmul_on_the_card_equals_the_cpu(card, m, k, n):
    """The padded `torch._int_mm` product: int32 accumulators bit for bit
    the CPU's, at the shapes the card pads (k = 25 and 27, n = 6, m = 1)."""
    from deepvision_tpu_torch.ops import quant
    rs = np.random.RandomState(m + k + n)
    a, w = _int8(rs, m, k), _int8(rs, n, k)
    got = quant.int8_matmul(a.to(card), w.to(card))
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), quant.int8_matmul(a, w))


@pytest.mark.parametrize("c,o,k,stride,pad,groups", [
    (1, 6, 5, 1, 0, 1),           # lenet's first conv: k = 25, n = 6
    (3, 64, 7, 2, 3, 1),          # the resnet stem: k = 147
    (3, 32, 3, 2, 1, 1),          # a 3-channel stem: k = 27
    (64, 256, 1, 1, 0, 1),        # a 1x1 conv
    (32, 32, 3, 1, 1, 32),        # depthwise
    (240, 240, 3, 2, 1, 240),     # depthwise, strided
    (24, 60, 1, 1, 0, 3),         # shufflenet's grouped 1x1
])
def test_int8_conv_on_the_card_equals_the_cpu(card, c, o, k, stride, pad,
                                              groups):
    from deepvision_tpu_torch.ops import quant
    rs = np.random.RandomState(c + o + k)
    x, w = _int8(rs, 2, c, 17, 17), _int8(rs, o, c // groups, k, k)
    got = quant.int8_conv2d(x.to(card), w.to(card), stride, pad, 1, groups)
    want = quant.int8_conv2d(x, w, stride, pad, 1, groups)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


def test_int8_vit_small_launches_k1_per_layer(card):
    """int8 vit_small on the card: attention stays on K1, 8 launches a
    dispatch, and the plan is 49 / 1 / 8."""
    from deepvision_tpu_torch.serve.quantize import arm_int8
    from deepvision_tpu_torch.utils.faults import FaultInjector
    engine = PredictEngine.from_config("vit_small", buckets=(1, 8),
                                       verbose=False)
    decision = arm_int8(engine, verbose=False, faults=FaultInjector(),
                        examples=8)
    plan = decision["plan"]
    assert (plan["quantized"], plan["skipped_head"],
            plan["fused_attention"]) == (49, 1, 8)
    x = np.zeros((8, *engine.example_shape), engine.input_dtype)
    before = port.flash_attention.launches
    engine.dispatch(x, precision="int8")
    torch.cuda.synchronize()
    assert port.flash_attention.launches - before == 8
