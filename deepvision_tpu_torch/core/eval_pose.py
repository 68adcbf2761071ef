"""Pose accuracy: PCKh, the percentage of correct keypoints (own copy of
deepvision_tpu/core/eval_pose.py: the MPII constants, `PoseEvaluator`,
`evaluate_pckh`).

A predicted joint is correct when its distance to the ground truth is at
most `threshold` x the person's reference length, the ground-truth head
segment |head_top - upper_neck| (MPII joints 9 and 8; the TFRecords carry
no head box). Persons whose head joints are missing are skipped. All
coordinates are normalized to [0, 1]; `aspect` (width / height) keeps
distances isotropic. The evaluator is numpy on the host and gives the JAX
module's numbers bit for bit; `evaluate_pckh` runs the model on the
state's device.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..utils.device import to_device, to_host

MPII_UPPER_NECK = 8
MPII_HEAD_TOP = 9

MPII_JOINT_NAMES = ["r_ankle", "r_knee", "r_hip", "l_hip", "l_knee", "l_ankle",
                    "pelvis", "thorax", "upper_neck", "head_top", "r_wrist",
                    "r_elbow", "r_shoulder", "l_shoulder", "l_elbow", "l_wrist"]


class PoseEvaluator:
    """Streaming PCKh accumulator over (pred, gt, visibility) keypoint sets."""

    def __init__(self, num_joints: int = 16,
                 thresholds: Sequence[float] = (0.5,),
                 head_joints: tuple = (MPII_UPPER_NECK, MPII_HEAD_TOP)):
        self.num_joints = num_joints
        self.thresholds = tuple(thresholds)
        self.head_joints = head_joints
        # per threshold: per-joint correct counts; shared per-joint totals
        self._correct = {t: np.zeros(num_joints) for t in self.thresholds}
        self._total = np.zeros(num_joints)

    def add_batch(self, pred_x, pred_y, gt_x, gt_y, visibility,
                  aspect: float = 1.0) -> None:
        """All arrays (B, K), coordinates in [0, 1]; visibility > 0 marks
        joints that exist (the converter writes 0/2)."""
        pred_x, pred_y, gt_x, gt_y = (np.asarray(a, np.float64)
                                      for a in (pred_x, pred_y, gt_x, gt_y))
        vis = np.asarray(visibility) > 0
        a, b = self.head_joints
        head = np.sqrt(((gt_x[:, a] - gt_x[:, b]) * aspect) ** 2 +
                       (gt_y[:, a] - gt_y[:, b]) ** 2)       # (B,)
        ok_person = vis[:, a] & vis[:, b] & (head > 1e-6)
        dist = np.sqrt(((pred_x - gt_x) * aspect) ** 2 + (pred_y - gt_y) ** 2)
        # a joint counts only when it AND the head reference exist
        counted = vis & ok_person[:, None] & (gt_x >= 0) & (gt_y >= 0)
        self._total += counted.sum(axis=0)
        for t in self.thresholds:
            hit = counted & (dist <= t * head[:, None])
            self._correct[t] += hit.sum(axis=0)

    def summarize(self, joint_names: Optional[Sequence[str]] = None
                  ) -> Dict[str, float]:
        """{"PCKh@<t>": mean over joints with data, "PCKh@<t>/<joint>": ...}."""
        names = joint_names or MPII_JOINT_NAMES
        out: Dict[str, float] = {}
        for t in self.thresholds:
            per_joint = []
            for j in range(self.num_joints):
                if self._total[j] == 0:
                    continue
                v = float(self._correct[t][j] / self._total[j])
                label = names[j] if j < len(names) else f"joint{j}"
                out[f"PCKh@{t:g}/{label}"] = v
                per_joint.append(v)
            out[f"PCKh@{t:g}"] = float(np.mean(per_joint)) if per_joint else 0.0
        return out


def evaluate_pckh(state, batches: Iterable, *, num_joints: int = 16,
                  thresholds: Sequence[float] = (0.5,)) -> Dict[str, float]:
    """PCKh of the model over (images, kp_x, kp_y, visibility) numpy
    batches: the last stack's heatmaps (the earlier heads are train-time
    supervision only), decoded per joint, from the inference-mode forward
    on the state's EMA weights when it keeps them."""
    from ..ops.heatmap import decode_keypoints

    ev = PoseEvaluator(num_joints=num_joints, thresholds=thresholds)
    model = state.model
    device = next(model.parameters()).device
    with state.ema_weights(), torch.inference_mode():
        model.eval()
        for images, kp_x, kp_y, vis in batches:
            outputs = model(to_device(images, device))
            px, py, _ = decode_keypoints(outputs[-1])
            ev.add_batch(px.cpu().numpy(), py.cpu().numpy(), to_host(kp_x),
                         to_host(kp_y), to_host(vis))
    return ev.summarize()
