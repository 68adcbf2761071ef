"""chip_smoke.py's phase 22 (the Keras, call-order and GAN checkpoint
importers) rehearsed on the CPU at small widths, the card stood in for by
the CPU: yolov3 and hourglass104 pinned narrow in their workdirs
(`P22_PINS`: width 1/16, one block a stage, one stack of order 2), the
yolov3 resume at 64 px and batch 2, hourglass104 served at 64 px, dcgan
at full width and cyclegan with one block at 32 px. The script's own
writers make every file; the port's readers and tools read them; K2's
plain version counts its calls as the kernel counts launches (one a step
and an eval batch), K1 and K2 stay idle in 22b-c."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def tiny_p22(monkeypatch, tmp_path):
    from deepvision_tpu_torch.ops import best_iou as best_iou_ops
    torch.set_num_threads(1)
    plain = best_iou_ops.best_iou_reference

    def counted(*args, **kwargs):
        chip_smoke.best_iou.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(best_iou_ops, "best_iou_reference", counted)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    for name, value in (
            ("P22_DEVICE", "cpu"), ("P15_DEVICE", "cpu"), ("P15_SIZE", 64),
            ("P15_BATCH", 2), ("P22_HG_SIZE", 64), ("P22_CG_BLOCKS", 1),
            ("P22_CG_SIZE", 32),
            ("P22_PINS", {"yolov3": {"width_mult": 0.0625,
                                     "stage_blocks": [1] * 5},
                          "hourglass104": {"width_mult": 0.0625,
                                           "num_stack": 1, "order": 2}})):
        monkeypatch.setattr(chip_smoke, name, value)


def test_phase_22_rehearses_on_the_cpu(tiny_p22):
    out = chip_smoke.check_importers()
    assert out["22a"]["launches"] == 2 + chip_smoke.P15_EVAL_BATCHES
    assert out["22a"]["heads_err"] <= chip_smoke.P22_HEADS_RTOL
    assert out["22b"]["err"] <= chip_smoke.P22_SERVE_TOL
    assert set(out["22c"]) == {"dcgan", "cyclegan"}
