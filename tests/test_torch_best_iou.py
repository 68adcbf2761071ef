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
