"""Port best-IoU (deepvision_tpu_torch/ops/best_iou.py) against the JAX
package on the CPU.

The same numpy boxes (seeded) go through the port's `best_iou_reference` —
the plain version of the CUDA kernel csrc/best_iou.cu, which a CPU tensor
takes — and through the JAX package's Pallas kernel under the interpreter
(`best_iou(..., interpret=True)`) and its jnp path
(`max(broadcast_iou)`). Bound: rtol and atol 1e-6, the JAX package's own
kernel-vs-jnp bound (tests/test_pallas_kernels.py): the same f32
operations in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.ops.boxes import broadcast_iou as jax_broadcast_iou
from deepvision_tpu.ops.pallas_kernels import best_iou as jax_best_iou
from deepvision_tpu_torch.ops import best_iou as port
from deepvision_tpu_torch.ops.boxes import broadcast_iou

BOUND = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _boxes(rs, b, n):
    xy1 = rs.uniform(0.0, 0.7, (b, n, 2))
    wh = rs.uniform(0.01, 0.35, (b, n, 2))
    return np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)


def _port(pred, gt):
    return port.best_iou_reference(torch.from_numpy(pred),
                                   torch.from_numpy(gt)).numpy()


@pytest.mark.parametrize("n,m", [(507, 100), (64, 100), (130, 3)])
def test_reference_matches_the_pallas_kernel_and_jnp(n, m):
    rs = np.random.RandomState(n + m)
    pred, gt = _boxes(rs, 2, n), _boxes(rs, 2, m)
    got = _port(pred, gt)
    kernel = np.asarray(jax_best_iou(jnp.asarray(pred), jnp.asarray(gt),
                                     interpret=True))
    plain = np.asarray(jnp.max(jax_broadcast_iou(jnp.asarray(pred),
                                                 jnp.asarray(gt)), axis=-1))
    assert got.shape == (2, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, kernel, **BOUND)
    np.testing.assert_allclose(got, plain, **BOUND)


def test_zero_gt_padding_rows_never_win():
    rs = np.random.RandomState(3)
    pred = _boxes(rs, 2, 600)          # more than one tile of BLOCK_N
    gt = _boxes(rs, 2, 100)
    gt[0, 4:] = 0.0
    gt[1, :] = 0.0                     # an image with no ground truth
    got = _port(pred, gt)
    kernel = np.asarray(jax_best_iou(jnp.asarray(pred), jnp.asarray(gt),
                                     interpret=True))
    np.testing.assert_allclose(got, kernel, **BOUND)
    assert np.all(got[1] == 0.0)
    np.testing.assert_allclose(got[0], _port(pred[:1], gt[:1, :4])[0],
                               **BOUND)


def test_exact_match_is_one():
    gt = np.array([[[0.2, 0.2, 0.5, 0.6], [0.0, 0.0, 0.0, 0.0]]], np.float32)
    got = _port(gt[:, :1], gt)
    assert got[0, 0] == pytest.approx(1.0, abs=1e-6)


def test_broadcast_iou_matches_jax():
    rs = np.random.RandomState(4)
    a, b = _boxes(rs, 3, 17), _boxes(rs, 3, 5)
    want = np.asarray(jax_broadcast_iou(jnp.asarray(a), jnp.asarray(b)))
    got = broadcast_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **BOUND)


def test_cpu_tensor_takes_the_plain_version_without_a_launch():
    rs = np.random.RandomState(5)
    pred = torch.from_numpy(_boxes(rs, 2, 40)).requires_grad_(True)
    gt = torch.from_numpy(_boxes(rs, 2, 7))
    before = port.best_iou.launches
    out = port.best_iou(pred, gt)
    assert port.best_iou.launches == before
    assert out.grad_fn is None          # detached, as under stop_gradient
    torch.testing.assert_close(out, port.best_iou_reference(pred, gt),
                               rtol=0, atol=0)
    # float64 is taken and computed in f32, as the JAX package casts
    out64 = port.best_iou(pred.double(), gt.double())
    assert out64.dtype == torch.float32
    torch.testing.assert_close(out64, out, rtol=0, atol=0)


@pytest.mark.parametrize("pred_shape,gt_shape,dtype,error", [
    ((2, 5, 4), (2, 3, 4), torch.bfloat16, TypeError),
    ((2, 5, 4), (2, 3, 4), torch.int32, TypeError),
    ((2, 5, 3), (2, 3, 4), torch.float32, ValueError),
    ((5, 4), (2, 3, 4), torch.float32, ValueError),
    ((2, 5, 4), (1, 3, 4), torch.float32, ValueError),
    ((2, 0, 4), (2, 3, 4), torch.float32, ValueError),
    ((2, 5, 4), (2, 0, 4), torch.float32, ValueError),
], ids=str)
def test_wrapper_refuses_what_the_kernel_does_not_take(pred_shape, gt_shape,
                                                       dtype, error):
    with pytest.raises(error):
        port.best_iou(torch.zeros(pred_shape, dtype=dtype),
                      torch.zeros(gt_shape, dtype=dtype))


# -- segments: the YOLO scales in one call ---------------------------------

def _jax_kernel(pred, gt):
    return np.asarray(jax_best_iou(jnp.asarray(pred), jnp.asarray(gt),
                                   interpret=True))


@pytest.mark.parametrize("m,padding", [(1, "none"), (3, "rows"),
                                       (100, "rows"), (300, "rows"),
                                       (100, "all")])
def test_segmented_reference_matches_the_pallas_kernel(m, padding):
    """Ragged segments (N_s = 1, 130, 507) against one GT list, segment by
    segment against the Pallas kernel under the interpreter; `rows` zeroes
    GT rows past a per-image count, `all` zeroes every GT row (all
    padding), so every IoU is 0."""
    rs = np.random.RandomState(m)
    preds = [_boxes(rs, 2, n) for n in (1, 130, 507)]
    gt = _boxes(rs, 2, m)
    if padding == "rows":
        gt[0, max(1, m // 2):] = 0.0
        gt[1, max(1, m // 3):] = 0.0
    elif padding == "all":
        gt[:] = 0.0
    got = port.best_iou_reference([torch.from_numpy(p) for p in preds],
                                  torch.from_numpy(gt))
    assert isinstance(got, list) and len(got) == 3
    for p, g in zip(preds, got):
        assert g.shape == (2, p.shape[1]) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _jax_kernel(p, gt), **BOUND)
        np.testing.assert_array_equal(g.numpy(), _port(p, gt))
    if padding == "all":
        assert all(np.all(g.numpy() == 0.0) for g in got)


def test_cpu_segments_take_the_plain_version_without_a_launch():
    rs = np.random.RandomState(6)
    preds = [torch.from_numpy(_boxes(rs, 2, n)) for n in (9, 1, 40)]
    gt = torch.from_numpy(_boxes(rs, 2, 5))
    before = port.best_iou.launches
    got = port.best_iou(preds, gt)
    assert port.best_iou.launches == before
    want = port.best_iou_reference(preds, gt)
    assert len(got) == 3
    for g, w, p in zip(got, want, preds):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        torch.testing.assert_close(g, port.best_iou(p, gt), rtol=0, atol=0)
    # a tuple is a sequence too; one segment still gives a list
    assert len(port.best_iou(tuple(preds), gt)) == 3
    assert isinstance(port.best_iou(preds[:1], gt), list)


@pytest.mark.parametrize("segments,gt_shape,error", [
    ((), (2, 3, 4), ValueError),                          # no segment
    (((2, 5, 4),) * (port.MAX_SEGMENTS + 1), (2, 3, 4), ValueError),
    (((2, 5, 4), (1, 5, 4)), (2, 3, 4), ValueError),      # batch differs
    (((2, 5, 4), (2, 0, 4)), (2, 3, 4), ValueError),      # empty segment
    (((2, 5, 4), (2, 5, 3)), (2, 3, 4), ValueError),
], ids=["none", "too-many", "batch", "empty", "not-boxes"])
def test_wrapper_refuses_bad_segments(segments, gt_shape, error):
    with pytest.raises(error):
        port.best_iou([torch.zeros(s) for s in segments],
                      torch.zeros(gt_shape))


@pytest.mark.parametrize("pred,gt", [
    ([[0.0, 0.0, 1.0, 1.0]], torch.zeros(1, 3, 4)),
    (torch.zeros(1, 5, 4), [[0.0, 0.0, 1.0, 1.0]]),
], ids=["pred", "gt"])
def test_wrapper_refuses_a_non_tensor(pred, gt):
    """The operator checks the inputs; the wrapper only refuses what it
    could not detach."""
    with pytest.raises(TypeError, match="takes tensors"):
        port.best_iou(pred, gt)


def test_zero_overlap_division_identity_in_f32():
    """csrc/best_iou.cu divides 2^-24 instead of a zero overlap (which
    would leave __fdiv_rn's fast path) and scales the quotient by 0. In
    IEEE f32 that equals 0 / union for every union: +-0 where it is +-0,
    NaN where it is NaN (0, NaN), never inf * 0 (denormals, huge)."""
    f32 = np.finfo(np.float32)
    uni = torch.tensor([1.0, -1.0, 1e-7, 3.0e38, -3.4e38, f32.tiny,
                        f32.smallest_subnormal, -f32.smallest_subnormal,
                        0.0, -0.0, float("inf"), float("-inf"),
                        float("nan")], dtype=torch.float32)
    want = torch.zeros_like(uni) / uni
    got = 0.0 * (torch.full_like(uni, 2.0 ** -24) / uni)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(want).sum() == 3
    assert torch.equal(got[~torch.isnan(want)], want[~torch.isnan(want)])
