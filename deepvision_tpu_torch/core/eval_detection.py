"""Detection accuracy evaluation: per-class AP, VOC mAP@0.5, COCO
mAP@[.5:.95] (own copy of deepvision_tpu/core/eval_detection.py: the whole
module, numpy only, so it gives the JAX module's numbers bit for bit).

- greedy score-ordered matching of detections to ground truth at an IoU
  threshold, each GT matched at most once (PASCAL VOC devkit semantics),
  or pycocotools' matching with crowd fallback and reassignment;
- AP as the interpolated 11-point mean (VOC2007), the area under the
  monotone precision envelope (VOC2010+, "all-point"), or the 101-point
  COCO sampling;
- COCO-style mAP averaged over IoU thresholds 0.50:0.05:0.95.

Evaluation runs on the host and streams per image. The device work (the
decoded forward and NMS, core/detection.py and ops/nms.py) hands over its
fixed-shape padded outputs through `add_batch`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

COCO_IOU_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05).round(2).tolist())


def np_iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray,
                  crowd_b: Optional[np.ndarray] = None) -> np.ndarray:
    """Pairwise IoU of corner boxes: (N,4) x (M,4) -> (N,M).

    Columns of `boxes_b` flagged in `crowd_b` use intersection-over-DET-area
    instead of intersection-over-union — pycocotools' iscrowd convention
    (a detection fully inside a crowd region scores 1 regardless of the
    crowd's extent)."""
    if boxes_a.size == 0 or boxes_b.size == 0:
        return np.zeros((boxes_a.shape[0], boxes_b.shape[0]), np.float64)
    a = boxes_a[:, None, :]  # (N,1,4)
    b = boxes_b[None, :, :]  # (1,M,4)
    ix1 = np.maximum(a[..., 0], b[..., 0])
    iy1 = np.maximum(a[..., 1], b[..., 1])
    ix2 = np.minimum(a[..., 2], b[..., 2])
    iy2 = np.minimum(a[..., 3], b[..., 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_a = np.clip(a[..., 2] - a[..., 0], 0, None) * np.clip(a[..., 3] - a[..., 1], 0, None)
    area_b = np.clip(b[..., 2] - b[..., 0], 0, None) * np.clip(b[..., 3] - b[..., 1], 0, None)
    union = area_a + area_b - inter
    if crowd_b is not None and np.any(crowd_b):
        union = np.where(np.asarray(crowd_b, bool)[None, :],
                         np.broadcast_to(area_a, union.shape), union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def average_precision(recall: np.ndarray, precision: np.ndarray,
                      mode: str = "area") -> float:
    """AP from a recall/precision curve (already sorted by ascending recall).

    mode="11point": VOC2007 interpolated mean of max-precision at r=0,0.1,...,1.
    mode="area": area under the monotonically-decreasing precision envelope
    (VOC2010+).
    mode="101point": the COCO protocol — the precision envelope sampled at
    recall thresholds 0:.01:1 (first curve point with recall >= threshold)
    and averaged; what pycocotools' accumulate() computes, and slightly
    different from the exact envelope area.
    """
    if recall.size == 0:
        return 0.0
    if mode == "11point":
        ap = 0.0
        for t in np.linspace(0.0, 1.0, 11):
            mask = recall >= t
            ap += (np.max(precision[mask]) if mask.any() else 0.0) / 11.0
        return float(ap)
    if mode == "101point":
        p = np.maximum.accumulate(precision[::-1])[::-1]
        inds = np.searchsorted(recall, np.linspace(0.0, 1.0, 101),
                               side="left")
        q = np.zeros(101)
        valid = inds < p.size
        q[valid] = p[inds[valid]]
        return float(q.mean())
    if mode != "area":
        raise ValueError(f"unknown AP mode {mode!r}")
    # envelope with sentinels, then sum rectangle areas where recall steps
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    p = np.maximum.accumulate(p[::-1])[::-1]
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


class DetectionEvaluator:
    """Streaming mAP accumulator.

    Feed per-image detections (any order) and ground truth; `summarize()` computes
    per-class AP at each IoU threshold and the VOC/COCO summary metrics. Boxes are
    corner-format (x1, y1, x2, y2) in any consistent coordinate space.
    """

    def __init__(self, num_classes: int,
                 iou_thresholds: Sequence[float] = (0.5,),
                 ap_mode: str = "area", match_mode: str = "voc",
                 max_dets: Optional[int] = None):
        if match_mode not in ("voc", "coco"):
            raise ValueError(f"unknown match_mode {match_mode!r}")
        self.num_classes = num_classes
        self.iou_thresholds = tuple(iou_thresholds)
        self.ap_mode = ap_mode
        self.match_mode = match_mode
        # top-k score cap per image per class before matching (pycocotools'
        # maxDets, 100 for the headline COCO metric); None = unlimited
        self.max_dets = max_dets
        # per image: dict with det boxes/scores/classes + gt boxes/classes/difficult
        self._images: List[dict] = []

    def add_image(self, det_boxes: np.ndarray, det_scores: np.ndarray,
                  det_classes: np.ndarray, gt_boxes: np.ndarray,
                  gt_classes: np.ndarray,
                  gt_difficult: Optional[np.ndarray] = None) -> None:
        det_boxes = np.asarray(det_boxes, np.float64).reshape(-1, 4)
        det_scores = np.asarray(det_scores, np.float64).reshape(-1)
        det_classes = np.asarray(det_classes, np.int64).reshape(-1)
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        gt_classes = np.asarray(gt_classes, np.int64).reshape(-1)
        if gt_difficult is None:
            gt_difficult = np.zeros(gt_boxes.shape[0], bool)
        self._images.append(dict(
            det_boxes=det_boxes, det_scores=det_scores, det_classes=det_classes,
            gt_boxes=gt_boxes, gt_classes=gt_classes,
            gt_difficult=np.asarray(gt_difficult, bool).reshape(-1)))

    def add_batch(self, nms_boxes, nms_scores, nms_classes, valid_counts,
                  gt_boxes, gt_classes, gt_valid, gt_difficult=None) -> None:
        """Consume one batch of padded fixed-shape arrays straight from
        `ops.nms.batched_nms` output + the padded GT the pipeline carries.

        nms_classes may be (B,D,C) per-class probs (argmax taken) or (B,D) ids;
        gt_difficult is an optional (B,N) padded 0/1 array.
        """
        nms_boxes = np.asarray(nms_boxes)
        nms_scores = np.asarray(nms_scores)
        nms_classes = np.asarray(nms_classes)
        valid_counts = np.asarray(valid_counts).astype(int)
        gt_boxes = np.asarray(gt_boxes)
        gt_classes = np.asarray(gt_classes)
        gt_valid = np.asarray(gt_valid).astype(bool)
        if gt_difficult is not None:
            gt_difficult = np.asarray(gt_difficult).astype(bool)
        if nms_classes.ndim == 3:
            nms_classes = np.argmax(nms_classes, axis=-1)
        for i in range(nms_boxes.shape[0]):
            n = valid_counts[i]
            m = gt_valid[i]
            self.add_image(nms_boxes[i, :n], nms_scores[i, :n],
                           nms_classes[i, :n], gt_boxes[i][m], gt_classes[i][m],
                           None if gt_difficult is None else gt_difficult[i][m])

    def _gather_class(self, cls: int):
        """Per-image detections/GT for one class, with score-sorted detections
        and the (threshold-independent) IoU matrix computed ONCE — matching at
        each IoU threshold then reuses these.

        Returns (per_image list of (scores_sorted, iou_sorted, difficult),
        n_positives).
        """
        per_image = []
        n_pos = 0
        for img in self._images:
            det_mask = img["det_classes"] == cls
            gt_mask = img["gt_classes"] == cls
            gt = img["gt_boxes"][gt_mask]
            difficult = img["gt_difficult"][gt_mask]
            n_pos += int((~difficult).sum())
            det = img["det_boxes"][det_mask]
            sc = img["det_scores"][det_mask]
            if det.shape[0] == 0 and gt.shape[0] == 0:
                continue
            order = np.argsort(-sc, kind="stable")
            if self.max_dets is not None:
                order = order[:self.max_dets]
            # coco mode scores crowd GT by intersection/det-area (iscrowd)
            crowd = difficult if self.match_mode == "coco" else None
            per_image.append((sc[order],
                              np_iou_matrix(det[order], gt, crowd_b=crowd),
                              difficult))
        return per_image, n_pos

    def _match_at_iou(self, per_image, n_pos: int, iou_thresh: float):
        """Greedy matching at one threshold → (ap, n_pos).

        match_mode="voc" — PASCAL devkit semantics: each detection (descending
        score) takes the argmax-IoU ground truth over ALL GT of its class; if
        IoU ≥ threshold and that GT is difficult → ignored, taken → FP, else
        TP. No reassignment to the next-best GT.

        match_mode="coco" — pycocotools `evaluateImg` semantics: each
        detection (descending score) takes the best-IoU ground truth among
        the still-unmatched REAL GT; only if none clears the threshold may
        it fall back to a crowd/ignore GT (detection then ignored, and the
        crowd stays matchable by later detections — `gtm[gind]>0 and not
        iscrowd[gind]` is pycocotools' skip rule). Crowd IoU is
        intersection-over-det-area (`_gather_class`).
        """
        scores, matches = [], []
        for sc, iou, difficult in per_image:
            taken = np.zeros(iou.shape[1], bool)
            for d in range(sc.shape[0]):
                scores.append(sc[d])
                if iou.shape[1] == 0:
                    matches.append(0)
                    continue
                if self.match_mode == "voc":
                    best = int(np.argmax(iou[d]))
                    if iou[d, best] >= iou_thresh:
                        if difficult[best]:
                            matches.append(-1)  # neither TP nor FP
                        elif not taken[best]:
                            taken[best] = True
                            matches.append(1)
                        else:
                            matches.append(0)  # GT already claimed → FP
                    else:
                        matches.append(0)
                else:  # coco: best still-unmatched real GT, crowd fallback
                    real = np.where(difficult | taken, -1.0, iou[d])
                    best = int(np.argmax(real))
                    if real[best] >= iou_thresh:
                        taken[best] = True
                        matches.append(1)
                        continue
                    ign = np.where(difficult, iou[d], -1.0)  # never 'taken'
                    if ign[int(np.argmax(ign))] >= iou_thresh:
                        matches.append(-1)  # matched crowd GT → ignored
                    else:
                        matches.append(0)
        if n_pos == 0:
            return float("nan"), 0
        matches = np.asarray(matches)[np.argsort(-np.asarray(scores),
                                                 kind="stable")]
        matches = matches[matches != -1]
        tp = np.cumsum(matches == 1)
        fp = np.cumsum(matches == 0)
        recall = tp / n_pos
        precision = tp / np.maximum(tp + fp, 1)
        return average_precision(recall, precision, self.ap_mode), n_pos

    def summarize(self) -> Dict[str, float]:
        """Compute summary metrics.

        Returns {"mAP@<t>": ..., "mAP": mean over thresholds, plus
        "AP@<t>/class<i>" per class with ground truth}. Classes absent from the
        ground truth are excluded from the means (NaN AP).
        """
        out: Dict[str, float] = {}
        thresh_aps: Dict[float, list] = {t: [] for t in self.iou_thresholds}
        for c in range(self.num_classes):
            per_image, n_pos = self._gather_class(c)
            if n_pos == 0:
                continue
            for t in self.iou_thresholds:
                ap, _ = self._match_at_iou(per_image, n_pos, t)
                out[f"AP@{t:g}/class{c}"] = ap
                thresh_aps[t].append(ap)
        per_thresh = []
        for t in self.iou_thresholds:
            m = float(np.mean(thresh_aps[t])) if thresh_aps[t] else 0.0
            out[f"mAP@{t:g}"] = m
            per_thresh.append(m)
        out["mAP"] = float(np.mean(per_thresh)) if per_thresh else 0.0
        return out


def make_evaluator(metric: str, num_classes: int) -> "DetectionEvaluator":
    """Dispatch on the metric name shared by every detector family's eval CLI:
    "coco" → mAP@[.5:.95], "voc" → all-point mAP@0.5, "voc07" → 11-point."""
    if metric == "coco":
        return coco_evaluator(num_classes)
    if metric in ("voc", "voc07"):
        return voc_evaluator(num_classes, use_07_metric=(metric == "voc07"))
    raise ValueError(f"unknown metric {metric!r}")


def coco_evaluator(num_classes: int) -> DetectionEvaluator:
    """mAP@[.5:.95] evaluator reproducing pycocotools' headline metric
    exactly: its matching (crowd fallback + reassignment), its 101-point
    interpolated AP, and its maxDets=100 cap. Fuzz-verified against a
    loop transcription of pycocotools and against the JAX package's
    evaluator in tests/test_torch_eval_detection.py."""
    return DetectionEvaluator(num_classes, COCO_IOU_THRESHOLDS,
                              ap_mode="101point", match_mode="coco",
                              max_dets=100)


def voc_evaluator(num_classes: int, use_07_metric: bool = False) -> DetectionEvaluator:
    """mAP@0.5 evaluator (PASCAL VOC devkit matching; 11-point interpolation if
    use_07_metric)."""
    return DetectionEvaluator(num_classes, (0.5,),
                              ap_mode="11point" if use_07_metric else "area",
                              match_mode="voc")
