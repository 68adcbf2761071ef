"""Port greedy NMS (deepvision_tpu_torch/ops/nms.py) against the JAX
package's `batched_nms` on the CPU.

Both get identical numpy inputs and must pick the same boxes in the same
order, with the same counts; the gathered boxes, scores and class
probabilities within 1e-7 (they are copies of the inputs, so in fact
equal). NMS is discontinuous: a pick flips where an IoU sits at the
threshold or two scores nearly tie. Each case therefore checks, in f64,
that no IoU between two live candidates of an image lies within 1e-6 of
`iou_thresh` and that no two of their scores differ by less than 1e-7
without being equal. The edge-case inputs are built so that this holds by
construction: coordinates on a 1/8 grid make every IoU a ratio a/u with
u <= 128, at least 1.5e-5 from the threshold 255/512, and scores on a 1/16
grid tie exactly or differ by 1/16. Exact ties are wanted: both take the
first maximal index.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from deepvision_tpu.ops.nms import batched_nms as jax_batched_nms
from deepvision_tpu_torch.ops.nms import batched_nms

GRID_IOU = 255 / 512      # no a/u with u <= 128 lies within 1.5e-5 of it
SCORE_THRESH = 0.5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.cache
def _jax_nms(iou_thresh, score_thresh, max_detection):
    return jax.jit(functools.partial(
        jax_batched_nms, iou_thresh=iou_thresh, score_thresh=score_thresh,
        max_detection=max_detection))


def _iou64(a, b):
    """Pairwise IoU in f64 with the kernel's clipping and epsilon."""
    a, b = a[:, None].astype(np.float64), b[None].astype(np.float64)
    iw = np.clip(np.minimum(a[..., 2], b[..., 2])
                 - np.maximum(a[..., 0], b[..., 0]), 0.0, 1.0)
    ih = np.clip(np.minimum(a[..., 3], b[..., 3])
                 - np.maximum(a[..., 1], b[..., 1]), 0.0, 1.0)
    inter = iw * ih
    area = lambda t: (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])  # noqa
    return inter / (area(a) + area(b) - inter + 1e-7)


def check_no_ties(boxes, scores, iou_thresh, score_thresh):
    """The inputs decide every pick with a margin: among each image's live
    candidates no IoU within 1e-6 of the threshold, no two scores within
    1e-7 of each other unless equal."""
    for bx, sc in zip(boxes, scores):
        live = sc >= score_thresh
        iou = _iou64(bx[live], bx[live])
        assert not (np.abs(iou - iou_thresh) < 1e-6).any()
        s = sc[live].astype(np.float64)
        gap = np.abs(s[:, None] - s[None, :])
        assert not ((gap > 0) & (gap < 1e-7)).any()


def grid_inputs(b, n, c, seed):
    """Boxes on the 1/8 grid (duplicates and zero-area boxes among them),
    scores on the 1/16 grid (exact ties, some below the threshold), one
    image with every score below it."""
    rs = np.random.RandomState(seed)
    lo = rs.randint(0, 8, (b, n, 2))
    hi = np.minimum(lo + rs.randint(0, 5, (b, n, 2)), 8)   # 0: zero area
    boxes = (np.concatenate([lo, hi], -1) / 8.0).astype(np.float32)
    if n > 1:
        boxes[:, 1] = boxes[:, 0]                           # a duplicate
    scores = (rs.randint(0, 17, (b, n)) / 16.0).astype(np.float32)
    if b > 1:
        scores[-1] = np.minimum(scores[-1], 0.25)           # nothing alive
    classes = rs.uniform(0, 1, (b, n, c)).astype(np.float32)
    return boxes, scores, classes


def _both(boxes, scores, classes, iou_thresh, score_thresh, max_det):
    want = [np.asarray(a) for a in _jax_nms(iou_thresh, score_thresh,
                                           max_det)(boxes, scores, classes)]
    got = [t.numpy() for t in batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(classes), iou_thresh=iou_thresh,
        score_thresh=score_thresh, max_detection=max_det)]
    return got, want


def _assert_same(got, want):
    gb, gs, gc, gn = got
    wb, ws, wc, wn = want
    assert gn.dtype == np.int32 and np.array_equal(gn, wn)
    assert gb.shape == wb.shape and gs.shape == ws.shape
    assert gc.shape == wc.shape
    for g, w in ((gb, wb), (gs, ws), (gc, wc)):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)


@pytest.mark.parametrize("max_det", [1, 5, 100])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("n", [1, 7, 300])
@pytest.mark.parametrize("b", [1, 3])
def test_picks_equal_jax_on_edge_case_inputs(b, n, c, max_det):
    boxes, scores, classes = grid_inputs(b, n, c, seed=b * 1000 + n + c)
    check_no_ties(boxes, scores, GRID_IOU, SCORE_THRESH)
    got, want = _both(boxes, scores, classes, GRID_IOU, SCORE_THRESH,
                      max_det)
    _assert_same(got, want)
    alive = (scores >= SCORE_THRESH).sum(axis=1)
    assert (got[3] <= np.minimum(alive, max_det)).all()
    if b > 1:
        assert got[3][-1] == 0 and not got[0][-1].any()  # all below thresh


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_picks_equal_jax_on_continuous_inputs(seed):
    """Uniform boxes and scores at the yolov3 thresholds of the predict
    step, more candidates than picks and fewer survivors than D."""
    rs = np.random.RandomState(seed)
    b, n, c = 2, 300, 4
    xy1 = rs.uniform(0, 0.7, (b, n, 2))
    wh = rs.uniform(0.05, 0.35, (b, n, 2))
    boxes = np.concatenate([xy1, np.minimum(xy1 + wh, 1.0)], -1).astype(
        np.float32)
    scores = rs.uniform(0, 1, (b, n)).astype(np.float32)
    classes = rs.uniform(0, 1, (b, n, c)).astype(np.float32)
    check_no_ties(boxes, scores, 0.5, 0.05)
    got, want = _both(boxes, scores, classes, 0.5, 0.05, 100)
    _assert_same(got, want)


def test_hand_fixture():
    boxes = np.array([[[0.0, 0.0, 0.4, 0.4],     # A: score .9
                       [0.05, 0.0, 0.45, 0.4],   # B: IoU(A) ~ .78 → gone
                       [0.6, 0.6, 0.9, 0.9],     # C: score .7 kept
                       [0.0, 0.6, 0.3, 0.9]]], np.float32)  # D: below
    scores = np.array([[0.9, 0.8, 0.7, 0.3]], np.float32)
    classes = np.array([[[1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]]],
                       np.float32)
    nb, ns, nc, count = (t.numpy() for t in batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(classes), iou_thresh=0.5, score_thresh=0.5,
        max_detection=4))
    assert int(count[0]) == 2
    np.testing.assert_allclose(ns[0, :2], [0.9, 0.7], atol=1e-6)
    np.testing.assert_allclose(nb[0, 0], [0.0, 0.0, 0.4, 0.4], atol=1e-6)
    np.testing.assert_allclose(nb[0, 1], [0.6, 0.6, 0.9, 0.9], atol=1e-6)
    np.testing.assert_allclose(nc[0, 1], [0.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(ns[0, 2:], 0.0, atol=1e-6)   # padding zero


def test_keeps_low_iou_same_scores():
    boxes = torch.tensor([[[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.7, 0.7]]])
    scores = torch.tensor([[0.8, 0.8]])
    _, _, _, count = batched_nms(boxes, scores, torch.ones(1, 2, 1),
                                 iou_thresh=0.5, score_thresh=0.5,
                                 max_detection=10)
    assert int(count[0]) == 2


def test_box_at_exactly_the_threshold_survives():
    """Suppression is IoU > thresh: a box whose IoU with the pick equals
    the threshold (the same f32 value, computed the same way) is kept."""
    boxes = torch.tensor([[[0.0, 0.0, 0.5, 0.5], [0.25, 0.0, 0.75, 0.5]]])
    scores = torch.tensor([[0.9, 0.8]])
    from deepvision_tpu_torch.ops.boxes import broadcast_iou
    iou = float(broadcast_iou(boxes[:, :1], boxes[:, 1:])[0, 0, 0])
    kw = dict(score_thresh=0.5, max_detection=3)
    assert int(batched_nms(boxes, scores, torch.ones(1, 2, 1),
                           iou_thresh=iou, **kw)[3][0]) == 2
    below = float(np.nextafter(np.float32(iou), np.float32(0)))
    assert int(batched_nms(boxes, scores, torch.ones(1, 2, 1),
                           iou_thresh=below, **kw)[3][0]) == 1


def naive_nms(boxes, scores, iou_thresh, score_thresh, max_det):
    """Plain-python greedy NMS (the oracle of tests/test_yolo.py)."""
    def iou(a, b):
        x1, y1 = max(a[0], b[0]), max(a[1], b[1])
        x2, y2 = min(a[2], b[2]), min(a[3], b[3])
        inter = max(0.0, min(x2 - x1, 1.0)) * max(0.0, min(y2 - y1, 1.0))
        ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
        return inter / (ua - inter + 1e-7)

    alive = [i for i in range(len(scores)) if scores[i] >= score_thresh]
    picks = []
    while alive and len(picks) < max_det:
        best = max(alive, key=lambda i: scores[i])
        picks.append(best)
        alive = [i for i in alive
                 if i != best and iou(boxes[best], boxes[i]) <= iou_thresh]
    return picks


def test_matches_naive_numpy_reference():
    rs = np.random.RandomState(7)
    for trial in range(5):
        n = 40
        xy1 = rs.uniform(0, 0.7, (n, 2))
        wh = rs.uniform(0.05, 0.35, (n, 2))
        boxes = np.concatenate([xy1, np.minimum(xy1 + wh, 1.0)], -1).astype(
            np.float32)
        scores = rs.uniform(0, 1, n).astype(np.float32)
        classes = np.eye(3)[rs.randint(0, 3, n)].astype(np.float32)
        check_no_ties(boxes[None], scores[None], 0.45, 0.3)
        picks = naive_nms(boxes, scores, 0.45, 0.3, 10)
        out_boxes, out_scores, _, count = (t.numpy() for t in batched_nms(
            torch.from_numpy(boxes[None]), torch.from_numpy(scores[None]),
            torch.from_numpy(classes[None]), iou_thresh=0.45,
            score_thresh=0.3, max_detection=10))
        assert int(count[0]) == len(picks), trial
        np.testing.assert_allclose(out_boxes[0, :len(picks)], boxes[picks],
                                   atol=1e-6)
        np.testing.assert_allclose(out_scores[0, :len(picks)],
                                   scores[picks], atol=1e-6)


def test_makes_no_host_sync_and_runs_every_iteration(monkeypatch):
    """The loop runs all max_detection iterations with no `.item()`, even
    when no candidate survives the first."""
    calls = []
    real_max = torch.Tensor.max

    def counted(self, *a, **k):
        calls.append(1)
        return real_max(self, *a, **k)

    def no_item(self):
        raise AssertionError("host sync inside batched_nms")

    monkeypatch.setattr(torch.Tensor, "max", counted)
    monkeypatch.setattr(torch.Tensor, "item", no_item)
    out = batched_nms(torch.rand(2, 5, 4), torch.zeros(2, 5),
                      torch.rand(2, 5, 3), score_thresh=0.5,
                      max_detection=7)
    assert len(calls) == 7 and out[3].tolist() == [0, 0]
