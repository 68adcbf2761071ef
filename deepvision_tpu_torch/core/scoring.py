"""Predict-side watch metrics: score a model family from its SERVING
outputs (port of deepvision_tpu/core/scoring.py, framework-free: numpy
only).

The promotion pipeline (serve/promote.py) replays a pinned shard through
the engine for two weight generations and reduces each generation's
outputs to the one scalar the family watches:

- classification: top-1 of the logits; segmentation: mIoU of the int32
  class-id masks;
- detection (YOLO serves decoded (boxes, objectness, class_probs) triples
  per scale): a box-count agreement score — per image, the anchors with
  objectness > 0.5 against the ground-truth box count, reduced as
  mean(1 / (1 + |pred - true|));
- pose (a heatmap per stack): PCK@0.2 on the last stack;
- centernet (a dict of heads per stack): the same box-count agreement over
  sigmoid(heatmap) peaks > 0.3 on the last stack.

The gates only compare score(A) - score(B) on identical pinned inputs, so
a proxy that tracks prediction movement is enough.

`pinned_shard` is the one source of those inputs: deterministic per
(config, size, dtype, examples, seed) down to the byte, and byte-equal to
the JAX package's (tests/test_torch_promote.py), built from each family's
own synthetic generator.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np

# families whose watched metric is computable from serving outputs — with
# the detection/pose/centernet proxies, every servable (non-GAN) family
GATED_FAMILIES = ("classification", "segmentation", "detection", "pose",
                  "centernet")

DEFAULT_SHARD_SEED = 12345

# decision thresholds of the count proxies (objectness sigmoid for YOLO,
# peak sigmoid for CenterNet's -2.19-biased heatmap head) and the PCK
# radius, in normalized coordinates
DETECTION_OBJ_THRESH = 0.5
CENTERNET_PEAK_THRESH = 0.3
PCK_RADIUS = 0.2


def watch_metric_name(cfg) -> str:
    """The scalar `score_serving_outputs` reduces to, for logs/healthz."""
    return {"classification": "top1", "segmentation": "miou",
            "detection": "box_count", "centernet": "box_count",
            "pose": "pck"}[cfg.family]


def serving_head_dims(cfg) -> frozenset:
    """Dimensions that identify the deliberate f32 output heads of a
    declared-bf16 model (the classifier's f32 dense head, the f32
    detection, pose and segmentation head convs): the layers an int8
    quantization plan keeps in float."""
    nc = cfg.data.num_classes
    dims = {nc}
    if cfg.family == "detection":        # YOLO: 3 anchors x (5 + nc) head
        dims.add(3 * (5 + nc))
    if cfg.family == "centernet":        # heatmap nc + wh/offset pairs, and
        dims.update({nc, 2, 64})         # the shared 64-wide f32 head conv
    if cfg.family == "pose":             # per-stack heatmap heads
        dims.add(nc)
    if cfg.family == "segmentation":     # the f32 1x1 class-logit head
        dims.add(nc)
    return frozenset(d for d in dims if d)


def pinned_shard(cfg, *, image_size: int, input_dtype,
                 examples: int = 64,
                 seed: int = DEFAULT_SHARD_SEED) -> Tuple[np.ndarray, tuple]:
    """One deterministic labeled batch for shadow eval / quantization
    calibration: `(images, targets)` where `targets` is the family's
    ground-truth tuple. Byte-identical per (config, image_size, dtype,
    examples, seed) — both gates score live-vs-candidate (or bf16-vs-int8)
    on IDENTICAL inputs, so the delta is pure weight/precision difference.
    Production deployments pass a real held-out shard instead; the
    synthetic default keeps the gates closed-loop testable with no data on
    disk."""
    h = int(image_size)
    ch = cfg.data.channels
    input_dtype = np.dtype(input_dtype)
    emit_uint8 = input_dtype == np.dtype(np.uint8)
    if cfg.family == "classification":
        from ..data.synthetic import SyntheticClassification
        gen = SyntheticClassification(
            examples, image_size=h, channels=ch,
            num_classes=cfg.data.num_classes, num_batches=1, seed=seed,
            emit_uint8=emit_uint8)
        images, labels = next(iter(gen))
        return images.astype(input_dtype), (np.asarray(labels, np.int64),)
    if cfg.family == "segmentation":
        from ..data.segmentation import SyntheticSegmentation
        gen = SyntheticSegmentation(
            examples, image_size=h, channels=ch,
            num_classes=cfg.data.num_classes, num_batches=1, seed=seed,
            emit_uint8=emit_uint8)
        images, masks = next(iter(gen))
        return images.astype(input_dtype), (np.asarray(masks, np.int64),)
    rs = np.random.RandomState(seed)
    if cfg.family in ("detection", "centernet"):
        from ..ops.yolo import MAX_BOXES
        images = (rs.randint(0, 256, (examples, h, h, ch))
                  if emit_uint8
                  else rs.rand(examples, h, h, ch) * 2.0 - 1.0)
        # varying per-example box counts: the count-agreement proxy needs
        # per-image diversity, unlike the uniform one-box grad-calibration
        # batch (core/detection.boxes_calibration_batch)
        boxes = np.zeros((examples, MAX_BOXES, 4), np.float32)
        classes = np.zeros((examples, MAX_BOXES), np.int32)
        valid = np.zeros((examples, MAX_BOXES), np.float32)
        counts = rs.randint(0, 4, size=(examples,))
        for i, n in enumerate(counts):
            for j in range(n):
                cx, cy = rs.uniform(0.2, 0.8, size=2)
                w = rs.uniform(0.1, 0.3)
                boxes[i, j] = [cx, cy, w, w]
                classes[i, j] = rs.randint(0, cfg.data.num_classes)
                valid[i, j] = 1.0
        return images.astype(input_dtype), (boxes, classes, valid)
    if cfg.family == "pose":
        k = cfg.data.num_classes           # keypoint count (MPII: 16)
        images = (rs.randint(0, 256, (examples, h, h, ch))
                  if emit_uint8 else rs.rand(examples, h, h, ch))
        kp_x = rs.rand(examples, k).astype(np.float32)
        kp_y = rs.rand(examples, k).astype(np.float32)
        visibility = (rs.rand(examples, k) > 0.2).astype(np.float32)
        return images.astype(input_dtype), (kp_x, kp_y, visibility)
    raise ValueError(
        f"config {cfg.name!r} (family {cfg.family!r}) has no predict-side "
        f"watch metric — gated families: {GATED_FAMILIES}")


def input_moments(images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel (mean, std) of one `(n, h, w, c)` image batch, float64:
    the one moment recipe for both sides of a drift comparison (the pinned
    shard's reference moments and a live window), so the two never
    disagree on normalization, dtype or axis order."""
    x = np.asarray(images, np.float64)
    if x.ndim != 4:
        raise ValueError(f"expected a (n, h, w, c) image batch, got shape "
                         f"{x.shape}")
    mean = x.mean(axis=(0, 1, 2))
    std = x.std(axis=(0, 1, 2))
    return mean, std


def moment_shift(ref_mean: np.ndarray, ref_std: np.ndarray,
                 mean: np.ndarray, std: np.ndarray) -> float:
    """Scalar drift score between two per-channel moment sets: the worst
    channel's |Δmean| in reference-std units, plus the worst relative std
    change — dimensionless, 0.0 for identical distributions, ~1.0 when a
    channel's mean moved one reference-σ."""
    ref_mean = np.asarray(ref_mean, np.float64)
    ref_std = np.asarray(ref_std, np.float64)
    eps = 1e-6
    dmean = float(np.max(np.abs(np.asarray(mean, np.float64) - ref_mean)
                         / (ref_std + eps)))
    dstd = float(np.max(np.abs(np.asarray(std, np.float64) - ref_std)
                        / (ref_std + eps)))
    return dmean + 0.5 * dstd


def _leaves(tree: Any) -> List[Any]:
    """The leaves of nested tuples, lists and mappings, in order (a
    mapping's in sorted-key order, as JAX's tree flattening takes them)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.clip(x, -30.0, 30.0)))


def _count_agreement(pred_counts: np.ndarray,
                     true_counts: np.ndarray) -> float:
    """mean(1 / (1 + |pred - true|)) in (0, 1] — 1.0 iff every image's
    predicted count matches; smooth in the miss size, so threshold-crossing
    perturbations (a regressed generation, a bad quantization) move it."""
    return float(np.mean(1.0 / (1.0 + np.abs(
        pred_counts.astype(np.float64) - true_counts.astype(np.float64)))))


def score_serving_outputs(cfg, outputs, targets) -> float:
    """Reduce one engine `predict()` output pytree + the pinned targets to
    the family's watched scalar. `outputs` is exactly what serving clients
    get (f32 logits / int32 masks / decoded triples / heatmaps)."""
    if cfg.family == "classification":
        (labels,) = targets
        logits = np.asarray(_leaves(outputs)[0])
        pred = np.argmax(logits, axis=-1).astype(np.int64)
        return float(np.mean(pred == np.asarray(labels)))
    if cfg.family == "segmentation":
        (masks,) = targets
        from .metrics import segmentation_scores
        nc = cfg.data.num_classes
        pred = np.asarray(_leaves(outputs)[0]).reshape(-1).astype(np.int64)
        true = np.asarray(masks).reshape(-1).astype(np.int64)
        cm = np.bincount(true * nc + pred, minlength=nc * nc)
        return float(segmentation_scores(cm.reshape(nc, nc))["miou"])
    if cfg.family == "detection":
        # decoded per-scale triples (boxes, objectness, class_probs); the
        # objectness leaves are every 2nd-of-3 leaf (models/yolo.py decode)
        _, _, valid = targets
        leaves = _leaves(outputs)
        if len(leaves) % 3:
            raise ValueError(f"expected per-scale decoded (boxes, "
                             f"objectness, class_probs) triples, got "
                             f"{len(leaves)} leaves")
        b = np.asarray(leaves[0]).shape[0]
        pred = np.zeros((b,), np.int64)
        for i in range(1, len(leaves), 3):      # the objectness leaves
            obj = np.asarray(leaves[i]).reshape(b, -1)
            pred += np.sum(obj > DETECTION_OBJ_THRESH, axis=-1)
        true = np.sum(np.asarray(valid) > 0, axis=-1)
        return _count_agreement(pred, true)
    if cfg.family == "centernet":
        # per-stack {heatmap, wh, offset} dicts: peaks of the LAST stack's
        # pre-sigmoid heatmap (bias -2.19 — models/centernet.py)
        _, _, valid = targets
        hm = np.asarray(outputs[-1]["heatmap"])
        b = hm.shape[0]
        peaks = _sigmoid(hm).reshape(b, -1) > CENTERNET_PEAK_THRESH
        true = np.sum(np.asarray(valid) > 0, axis=-1)
        return _count_agreement(np.sum(peaks, axis=-1), true)
    if cfg.family == "pose":
        kp_x, kp_y, vis = targets
        hm = np.asarray(outputs[-1] if isinstance(outputs, (tuple, list))
                        else outputs)           # last stack (B, h, w, K)
        b, hh, ww, k = hm.shape
        flat = hm.reshape(b, hh * ww, k)
        idx = np.argmax(flat, axis=1)            # (B, K)
        py = (idx // ww) / max(hh - 1, 1)
        px = (idx % ww) / max(ww - 1, 1)
        d = np.sqrt((px - np.asarray(kp_x)) ** 2
                    + (py - np.asarray(kp_y)) ** 2)
        v = np.asarray(vis) > 0
        hits = (d < PCK_RADIUS) & v
        n_vis = max(int(np.sum(v)), 1)
        return float(np.sum(hits) / n_vis)
    raise ValueError(
        f"config {cfg.name!r} (family {cfg.family!r}) has no predict-side "
        f"watch metric — gated families: {GATED_FAMILIES}")
