"""Port mAP evaluator (deepvision_tpu_torch/core/eval_detection.py) on the
CPU: every hand-computed case of tests/test_eval_detection.py with the
same expected values, the loop transcription of pycocotools' evaluateImg
and accumulate from that file as an oracle, and the JAX package's own
evaluator on seeded random detections and ground truth, where the
summaries must be equal dict for dict (the same numpy operations in the
same order). The pycocotools cross-check is not ported: it needs a
package this repo does not install.
"""

import numpy as np
import pytest

from deepvision_tpu.core import eval_detection as jax_eval
from deepvision_tpu_torch.core import eval_detection as port_eval
from deepvision_tpu_torch.core.eval_detection import (
    COCO_IOU_THRESHOLDS, DetectionEvaluator, average_precision, coco_evaluator,
    make_evaluator, np_iou_matrix, voc_evaluator)
from test_eval_detection import _oracle_coco_map, _random_scenes


def box(x1, y1, x2, y2):
    return np.array([x1, y1, x2, y2], np.float64)


class TestIoU:
    def test_identical(self):
        b = box(0, 0, 10, 10)[None]
        assert np_iou_matrix(b, b)[0, 0] == pytest.approx(1.0)

    def test_half_overlap(self):
        # [0,10]x[0,10] vs [5,15]x[0,10]: inter 50, union 150 → 1/3
        a = box(0, 0, 10, 10)[None]
        b = box(5, 0, 15, 10)[None]
        assert np_iou_matrix(a, b)[0, 0] == pytest.approx(1 / 3)

    def test_disjoint_and_empty(self):
        a = box(0, 0, 1, 1)[None]
        b = box(5, 5, 6, 6)[None]
        assert np_iou_matrix(a, b)[0, 0] == 0.0
        assert np_iou_matrix(np.zeros((0, 4)), b).shape == (0, 1)


class TestAveragePrecision:
    def test_perfect_detector_area(self):
        recall = np.array([0.5, 1.0])
        precision = np.array([1.0, 1.0])
        assert average_precision(recall, precision, "area") == pytest.approx(1.0)

    def test_single_point_area(self):
        # one TP out of 2 GT at precision 1: envelope is p=1 until r=0.5 → AP 0.5
        assert average_precision(np.array([0.5]), np.array([1.0]),
                                 "area") == pytest.approx(0.5)

    def test_11point(self):
        # max precision 1.0 for r in {0,.1,...,.5} (6 points), 0 beyond → 6/11
        assert average_precision(np.array([0.5]), np.array([1.0]),
                                 "11point") == pytest.approx(6 / 11)

    def test_zigzag_envelope(self):
        # detections: TP, FP, TP over 2 GT.
        # cum tp=[1,1,2], fp=[0,1,1] → recall=[.5,.5,1], prec=[1,.5,2/3]
        # envelope: p=1 on [0,.5], p=2/3 on (.5,1] → AP = .5*1 + .5*2/3 = 5/6
        recall = np.array([0.5, 0.5, 1.0])
        precision = np.array([1.0, 0.5, 2 / 3])
        assert average_precision(recall, precision, "area") == pytest.approx(5 / 6)


class TestEvaluator:
    def test_perfect_single_class(self):
        ev = voc_evaluator(num_classes=1)
        gt = np.stack([box(0, 0, 10, 10), box(20, 20, 30, 30)])
        ev.add_image(gt, np.array([0.9, 0.8]), np.array([0, 0]),
                     gt, np.array([0, 0]))
        s = ev.summarize()
        assert s["mAP@0.5"] == pytest.approx(1.0)

    def test_one_tp_one_fp(self):
        # 2 GT; det1 matches GT1 (score .9), det2 matches nothing (score .8).
        # AP(area) = 0.5 (precision envelope 1.0 up to recall .5, then 0).
        ev = voc_evaluator(num_classes=1)
        gt = np.stack([box(0, 0, 10, 10), box(50, 50, 60, 60)])
        det = np.stack([box(0, 0, 10, 10), box(100, 100, 110, 110)])
        ev.add_image(det, np.array([0.9, 0.8]), np.array([0, 0]),
                     gt, np.array([0, 0]))
        assert ev.summarize()["mAP@0.5"] == pytest.approx(0.5)

    def test_duplicate_detection_is_fp(self):
        # Two detections on the same GT: second is a false positive (greedy,
        # one-match-per-GT). 1 GT: tp=[1,1], fp=[0,1] → recall [1,1],
        # prec [1,.5] → AP(area)=1.0*1=1? envelope max precision at r=1 is 1.0
        # → AP=1.0. Use score ordering so the IoU=1 det wins.
        ev = voc_evaluator(num_classes=1)
        g = box(0, 0, 10, 10)[None]
        det = np.stack([box(0, 0, 10, 10), box(1, 0, 11, 10)])
        ev.add_image(det, np.array([0.9, 0.8]), np.array([0, 0]),
                     g, np.array([0]))
        assert ev.summarize()["mAP@0.5"] == pytest.approx(1.0)

    def test_low_score_tp_after_fp(self):
        # FP at score .9, TP at score .8, 1 GT:
        # sorted: [FP, TP] → tp=[0,1], fp=[1,1] → recall [0,1], prec [0,.5]
        # envelope → AP(area) = 0.5
        ev = voc_evaluator(num_classes=1)
        g = box(0, 0, 10, 10)[None]
        det = np.stack([box(100, 100, 110, 110), box(0, 0, 10, 10)])
        ev.add_image(det, np.array([0.9, 0.8]), np.array([0, 0]),
                     g, np.array([0]))
        assert ev.summarize()["mAP@0.5"] == pytest.approx(0.5)

    def test_wrong_class_no_match(self):
        ev = voc_evaluator(num_classes=2)
        g = box(0, 0, 10, 10)[None]
        ev.add_image(g, np.array([0.9]), np.array([1]),  # predicted class 1
                     g, np.array([0]))                    # GT class 0
        s = ev.summarize()
        assert s["AP@0.5/class0"] == pytest.approx(0.0)
        assert "AP@0.5/class1" not in s  # no GT for class 1 → excluded

    def test_difficult_gt_ignored(self):
        # VOC: detection matching a difficult GT is neither TP nor FP.
        ev = voc_evaluator(num_classes=1)
        gt = np.stack([box(0, 0, 10, 10), box(50, 50, 60, 60)])
        det = np.stack([box(0, 0, 10, 10), box(50, 50, 60, 60)])
        ev.add_image(det, np.array([0.9, 0.8]), np.array([0, 0]),
                     gt, np.array([0, 0]), gt_difficult=np.array([True, False]))
        # only GT2 counts (n_pos=1); det1 ignored, det2 TP → AP 1.0
        assert ev.summarize()["mAP@0.5"] == pytest.approx(1.0)

    def test_iou_threshold_sweep(self):
        # det has IoU 0.6 with GT: TP at 0.5, FP at 0.7.
        ev = DetectionEvaluator(num_classes=1, iou_thresholds=(0.5, 0.7))
        g = box(0, 0, 10, 10)[None]
        d = box(0, 0, 10, 6)[None]  # inter 60, union 100 → IoU 0.6
        ev.add_image(d, np.array([0.9]), np.array([0]), g, np.array([0]))
        s = ev.summarize()
        assert s["mAP@0.5"] == pytest.approx(1.0)
        assert s["mAP@0.7"] == pytest.approx(0.0)
        assert s["mAP"] == pytest.approx(0.5)

    def test_coco_thresholds(self):
        ev = coco_evaluator(num_classes=1)
        assert len(ev.iou_thresholds) == 10
        assert COCO_IOU_THRESHOLDS[0] == 0.5 and COCO_IOU_THRESHOLDS[-1] == 0.95

    def test_11point_vs_area(self):
        v07 = voc_evaluator(num_classes=1, use_07_metric=True)
        g = np.stack([box(0, 0, 10, 10), box(50, 50, 60, 60)])
        d = box(0, 0, 10, 10)[None]
        v07.add_image(d, np.array([0.9]), np.array([0]), g, np.array([0, 0]))
        assert v07.summarize()["mAP@0.5"] == pytest.approx(6 / 11)

    def test_add_batch_padded(self):
        # padded fixed-shape path mirroring batched_nms outputs
        ev = voc_evaluator(num_classes=2)
        D, N = 4, 3
        nms_boxes = np.zeros((1, D, 4))
        nms_boxes[0, 0] = box(0, 0, 10, 10)
        nms_scores = np.zeros((1, D)); nms_scores[0, 0] = 0.9
        nms_classes = np.zeros((1, D, 2)); nms_classes[0, 0, 1] = 1.0  # class 1
        counts = np.array([1])
        gt_boxes = np.zeros((1, N, 4)); gt_boxes[0, 0] = box(0, 0, 10, 10)
        gt_classes = np.zeros((1, N), np.int64); gt_classes[0, 0] = 1
        gt_valid = np.zeros((1, N)); gt_valid[0, 0] = 1
        ev.add_batch(nms_boxes, nms_scores, nms_classes, counts,
                     gt_boxes, gt_classes, gt_valid)
        assert ev.summarize()["mAP@0.5"] == pytest.approx(1.0)

    def test_no_gt_class_excluded_from_mean(self):
        ev = voc_evaluator(num_classes=3)
        g = box(0, 0, 10, 10)[None]
        ev.add_image(g, np.array([0.9]), np.array([0]), g, np.array([0]))
        s = ev.summarize()
        assert s["mAP@0.5"] == pytest.approx(1.0)  # classes 1,2 have no GT


def test_perfect_predictions_give_map_1():
    """Oracle detections fed through add_batch at COCO thresholds → mAP 1.0."""
    from deepvision_tpu_torch.core.eval_detection import coco_evaluator

    rs = np.random.RandomState(0)
    ev = coco_evaluator(num_classes=5)
    for _ in range(3):
        n = 4
        xy1 = rs.uniform(0, 0.5, (n, 2))
        gt_boxes = np.concatenate([xy1, xy1 + rs.uniform(0.1, 0.4, (n, 2))], -1)
        gt_classes = rs.randint(0, 5, n)
        ev.add_image(gt_boxes, rs.uniform(0.5, 1.0, n), gt_classes,
                     gt_boxes, gt_classes)
    assert ev.summarize()["mAP"] == pytest.approx(1.0)


def test_devkit_no_reassignment():
    """VOC devkit: a detection whose argmax-IoU GT is already taken is a FP —
    no reassignment to the next-best overlapping GT (unlike COCO matching)."""
    from deepvision_tpu_torch.core.eval_detection import voc_evaluator

    ev = voc_evaluator(num_classes=1)
    # Two overlapping GT; d1 takes GT1 (IoU 1.0); d2 has IoU 0.9-ish with GT1
    # (taken) and ~0.55 with GT2 → devkit counts d2 FP, GT2 stays unmatched.
    gt1 = box(0.0, 0.0, 10.0, 10.0)
    gt2 = box(0.0, 4.5, 10.0, 14.5)
    d2 = box(0.0, 1.0, 10.0, 11.0)  # IoU(gt1)=9/11≈0.82, IoU(gt2)=6.5/13.5≈0.48... 
    # adjust so IoU(d2,gt2) ≥ 0.5 but < IoU(d2,gt1):
    d2 = box(0.0, 2.0, 10.0, 12.0)  # IoU(gt1)=8/12≈0.67, IoU(gt2)=7.5/12.5=0.6
    ev.add_image(np.stack([gt1, d2]), np.array([0.9, 0.8]), np.array([0, 0]),
                 np.stack([gt1, gt2]), np.array([0, 0]))
    # tp=[1,1] fp=[0,1] over n_pos=2 → recall [.5,.5], prec [1,.5] → AP .5
    assert ev.summarize()["mAP@0.5"] == pytest.approx(0.5)


def test_coco_reassignment_matches_pycocotools_semantics():
    """COCO matching reassigns a detection to the best still-unmatched GT;
    VOC devkit counts the same detection as FP. Two overlapping GT, two
    detections both closest to GT1."""
    from deepvision_tpu_torch.core.eval_detection import DetectionEvaluator

    gt1 = box(0.0, 0.0, 10.0, 10.0)
    gt2 = box(0.0, 4.0, 10.0, 14.0)
    d1 = gt1                          # IoU(gt1)=1.0
    d2 = box(0.0, 1.0, 10.0, 11.0)    # IoU(gt1)=9/11≈.82 > IoU(gt2)=7/13≈.54

    coco = DetectionEvaluator(1, (0.5,), match_mode="coco")
    coco.add_image(np.stack([d1, d2]), np.array([0.9, 0.8]), np.array([0, 0]),
                   np.stack([gt1, gt2]), np.array([0, 0]))
    assert coco.summarize()["mAP@0.5"] == pytest.approx(1.0)  # d2 → GT2

    voc = DetectionEvaluator(1, (0.5,), match_mode="voc")
    voc.add_image(np.stack([d1, d2]), np.array([0.9, 0.8]), np.array([0, 0]),
                  np.stack([gt1, gt2]), np.array([0, 0]))
    # d2's argmax GT is taken → FP: recall caps at .5, AP(area)=.5
    assert voc.summarize()["mAP@0.5"] == pytest.approx(0.5)




@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_coco_evaluator_matches_loop_oracle(seed):
    rs = np.random.RandomState(seed)
    scenes = _random_scenes(rs)
    ev = coco_evaluator(6)
    for s in scenes:
        ev.add_image(s["det_boxes"], s["det_scores"], s["det_classes"],
                     s["gt_boxes"], s["gt_classes"],
                     gt_difficult=s["gt_crowd"])
    got = ev.summarize()
    want = _oracle_coco_map(scenes, 6, COCO_IOU_THRESHOLDS)
    for t in COCO_IOU_THRESHOLDS:
        assert got[f"mAP@{t:g}"] == pytest.approx(want[t], abs=1e-9), (
            seed, t)
    assert got["mAP"] == pytest.approx(
        float(np.mean(list(want.values()))), abs=1e-9)


def _padded_batches(rs, num_classes, difficult):
    """Seeded batches in the layout `add_batch` takes: NMS-shaped padded
    detections with per-class probabilities and counts, padded GT with
    valid flags and, optionally, difficult flags."""
    out = []
    for _ in range(3):
        b, d, n = 4, 12, 6
        xy = rs.uniform(0, 0.7, (b, n, 2))
        gt = np.concatenate([xy, xy + rs.uniform(0.05, 0.3, (b, n, 2))], -1)
        gt_classes = rs.randint(0, num_classes, (b, n))
        gt_valid = (rs.rand(b, n) < 0.7).astype(np.float32)
        det = np.repeat(gt, 2, axis=1) + rs.uniform(-0.05, 0.05, (b, 2 * n, 4))
        det = det[:, :d].astype(np.float32)
        scores = rs.uniform(0, 1, (b, d)).astype(np.float32)
        probs = rs.uniform(0, 1, (b, d, num_classes)).astype(np.float32)
        counts = rs.randint(0, d + 1, b)
        flags = ((rs.rand(b, n) < 0.3).astype(np.float32) if difficult
                 else None)
        out.append((det, scores, probs, counts, gt.astype(np.float32),
                    gt_classes, gt_valid, flags))
    return out


@pytest.mark.parametrize("difficult", [False, True],
                         ids=["plain", "difficult"])
@pytest.mark.parametrize("metric", ["coco", "voc", "voc07"])
def test_summaries_equal_the_jax_evaluator(metric, difficult):
    batches = _padded_batches(np.random.RandomState(11), 5, difficult)
    port, ref = make_evaluator(metric, 5), jax_eval.make_evaluator(metric, 5)
    for *arrays, flags in batches:
        port.add_batch(*arrays, gt_difficult=flags)
        ref.add_batch(*arrays, gt_difficult=flags)
    got, want = port.summarize(), ref.summarize()
    assert got == want and len(got) > 2
    assert any(0.0 < v < 1.0 for v in got.values())


def test_random_scenes_with_crowd_equal_the_jax_evaluator():
    scenes = _random_scenes(np.random.RandomState(3))
    for make in (lambda m: m.coco_evaluator(6),
                 lambda m: m.voc_evaluator(6),
                 lambda m: m.DetectionEvaluator(6, (0.5, 0.75),
                                                match_mode="coco")):
        summaries = []
        for module in (jax_eval, port_eval):
            ev = make(module)
            for s in scenes:
                ev.add_image(s["det_boxes"], s["det_scores"],
                             s["det_classes"], s["gt_boxes"],
                             s["gt_classes"], gt_difficult=s["gt_crowd"])
            summaries.append(ev.summarize())
        assert summaries[0] == summaries[1]


def test_make_evaluator_dispatch():
    assert make_evaluator("coco", 3).iou_thresholds == COCO_IOU_THRESHOLDS
    assert make_evaluator("voc", 3).ap_mode == "area"
    assert make_evaluator("voc07", 3).ap_mode == "11point"
    with pytest.raises(ValueError, match="unknown metric"):
        make_evaluator("f1", 3)
    with pytest.raises(ValueError, match="unknown match_mode"):
        DetectionEvaluator(1, match_mode="kitti")
    with pytest.raises(ValueError, match="unknown AP mode"):
        average_precision(np.array([0.5]), np.array([1.0]), "bogus")


def test_add_batch_difficult_flags():
    from deepvision_tpu_torch.core.eval_detection import voc_evaluator

    ev = voc_evaluator(num_classes=1)
    N = 2
    det_boxes = np.zeros((1, N, 4)); det_boxes[0, 0] = box(0, 0, 10, 10)
    det_scores = np.zeros((1, N)); det_scores[0, 0] = 0.9
    det_classes = np.zeros((1, N, 1)); det_classes[0, 0, 0] = 1.0
    counts = np.array([1])
    gt_boxes = np.zeros((1, N, 4))
    gt_boxes[0, 0] = box(0, 0, 10, 10)       # difficult
    gt_boxes[0, 1] = box(50, 50, 60, 60)     # easy, missed
    gt_classes = np.zeros((1, N), np.int64)
    gt_valid = np.ones((1, N))
    gt_difficult = np.array([[1.0, 0.0]])
    ev.add_batch(det_boxes, det_scores, det_classes, counts,
                 gt_boxes, gt_classes, gt_valid, gt_difficult=gt_difficult)
    # the only detection matches difficult GT → ignored; n_pos=1 (easy GT),
    # zero TP/FP → empty PR curve → AP 0
    assert ev.summarize()["mAP@0.5"] == pytest.approx(0.0)
