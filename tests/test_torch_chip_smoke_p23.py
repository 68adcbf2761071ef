"""Phase 23 of chip_smoke.py (the IR audit on the card) rehearsed on the
CPU at small sizes: 23a's background audit started and collected as the
script does it (lenet5 alone), and the recorder's counts of 23b and 23c
on real CPU tensors (K1's and K2's CPU implementations launch nothing,
so the launch counts are the card's alone): the exported vit_tiny
program holds one K1 node a layer, each node's output equal to the plain
version, and FLOPs equal to the fake-traced `vit_tiny/serve` row; a real
yolov3_digits train step holds one K2 node, its output the plain
version's bit for bit, and FLOPs equal to the fake-traced
`yolov3_digits/train` row."""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs                                     # noqa: E402
from deepvision_tpu_torch.check.harness import AUDIT_BATCH  # noqa: E402
from deepvision_tpu_torch.configs import get_config         # noqa: E402
from deepvision_tpu_torch.core import export as model_export  # noqa: E402
from deepvision_tpu_torch.core.detection import (           # noqa: E402
    boxes_calibration_batch, make_yolo_train_step, yolo_grid_sizes)
from deepvision_tpu_torch.core.optim import build_optimizer  # noqa: E402
from deepvision_tpu_torch.core.train_state import TrainState  # noqa: E402
from deepvision_tpu_torch.models import build_model         # noqa: E402
from deepvision_tpu_torch.ops.attention import (            # noqa: E402
    flash_attention_reference)
from deepvision_tpu_torch.ops.best_iou import best_iou_reference  # noqa


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_phase_23a_rehearses_on_the_cpu(monkeypatch):
    monkeypatch.setattr(cs, "P23_UNITS", ("lenet5",))
    run = cs.start_p23_audit()
    out = cs.check_p23_audit(run, cs.p23_baseline())
    assert out["rc"] == 0 and out["units"] == 3
    assert out["drift"]["flops"] == 0.0


def test_phase_23b_program_counts_on_the_cpu():
    base = cs.p23_baseline()["units"]
    model = build_model(get_config("vit_tiny")).eval()
    program = model_export.export_program(model, (32, 32, 3),
                                          batch_size=AUDIT_BATCH)
    x = torch.randn(AUDIT_BATCH, 32, 32, 3,
                    generator=torch.Generator().manual_seed(23))
    rec = cs.P23Capture()
    with torch.inference_mode(), rec:
        logits = program.module()(x)
    assert rec.trace.count("deepvision.flash_attention") == 4
    assert rec.trace.flops == base["vit_tiny/serve"]["flops"]
    assert len(rec.calls) == 4 and torch.isfinite(logits).all()
    for _, (q, k, v, scale), out in rec.calls:
        ref = flash_attention_reference(q, k, v, scale=scale)
        assert torch.equal(out, ref)


def test_phase_23c_train_step_counts_on_the_cpu():
    base = cs.p23_baseline()["units"]
    cfg = get_config("yolov3_digits")
    size = cfg.data.image_size
    model = build_model(cfg)
    state = TrainState(model, build_optimizer(
        model.parameters(), cfg.optimizer, cfg.schedule, 1,
        cfg.total_epochs), seed=cfg.seed)
    step = make_yolo_train_step(num_classes=cfg.data.num_classes,
                                grid_sizes=yolo_grid_sizes(size),
                                compute_dtype=torch.bfloat16)
    batch = [torch.from_numpy(a) for a in boxes_calibration_batch(
        cfg, (size, size, 3), AUDIT_BATCH, seed=23)]
    rec = cs.P23Capture()
    with torch.autograd.set_multithreading_enabled(False), rec:
        metrics = step(state, *batch)
    assert rec.trace.count("deepvision.best_iou") == 1
    assert rec.trace.flops == base["yolov3_digits/train"]["flops"]
    ((_, (preds, gt), outs),) = rec.calls
    for out, ref in zip(outs, best_iou_reference(list(preds), gt)):
        assert cs.same(out, ref)
    assert torch.isfinite(metrics["loss"])
