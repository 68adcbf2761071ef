"""chip_smoke.py's phase 15 (resilient training) rehearsed on the CPU at a
small size, the card stood in for by the CPU
(tests/test_torch_chip_smoke.py::_card_on_the_cpu): yolov3_digits at 64
px and batch 2 in place of yolov3 at 416 px and batch 16, the train.py
subprocesses of 15c with `--device cpu`. The watchdog keeps the card's
threshold, P15_WATCHDOG_SECS: like the JAX trainer, the trainer does not
feed it across the end-of-epoch evaluation and checkpoint save, which on a
loaded CPU (several test workers) can outlast a shorter one before the
stall is injected. Every sub-phase
runs end to end: the rollback and its events, K2's plain version counted
once per train step (the diverged and the retried epoch's included) and
per eval batch, the save overlap, fallback, strict, fsck's exit codes,
SIGTERM and --auto-resume, SIGKILL during a save, the watchdog, and the
served provenance and refusal."""

import os
import sys
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from test_torch_chip_smoke import _card_on_the_cpu  # noqa: E402


@pytest.fixture
def tiny_p15(monkeypatch):
    """Phase 15 at the sizes above; K2's plain version, which the CPU
    runs, counts its calls as the kernel counts its launches."""
    from deepvision_tpu_torch.ops import yolo as yolo_ops
    _card_on_the_cpu(monkeypatch)
    torch.set_num_threads(1)
    plain = yolo_ops.best_iou

    def counted(*args, **kwargs):
        chip_smoke.best_iou.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(yolo_ops, "best_iou", counted)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for name, value in (("YOLO_MODEL", "yolov3_digits"), ("P15_SIZE", 64),
                        ("P15_BATCH", 2), ("P15_DEVICE", "cpu"),
                        ("P15_TIMED_STEPS", 2), ("P15_TIMEOUT", 240)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_phase_15_rehearses_on_the_cpu(tiny_p15):
    out = chip_smoke.check_resilience()
    a = out["15a"]
    assert a["events"]["resilience_divergence_recoveries"] == [1.0]
    assert a["events"]["resilience_lr_scale"] == [0.5]
    assert a["train_steps"] == 9 and a["eval_batches"] == 4
    assert a["launches"] == 13
    assert a["save"]["bytes"] > 0 and a["overlap"]["during_steps"] >= 1
    assert out["15b"]["fsck"] == [0, 1, 1, 0]
    assert out["15c"]["sigkill_resumed"] == \
        out["15c"]["sigkill_committed"][-1] or \
        out["15c"]["sigkill_resumed"] < out["15c"]["sigkill_committed"][-1]
    assert out["15d"]["step"] == chip_smoke.P15_STEPS
    assert out["15e"]["provenance"]["verified"] is True


def test_a_stray_kernel_launch_fails_phase_15(monkeypatch):
    """A sub-phase whose launch counts differ from the expected fails."""
    trainer = types.SimpleNamespace(model=None)
    monkeypatch.setattr(chip_smoke, "check_p15_divergence",
                        lambda: {"trainer": trainer})
    monkeypatch.setattr(chip_smoke, "start_p15_save_overlap",
                        lambda trainer: {})
    monkeypatch.setattr(chip_smoke, "check_p15_save_overlap",
                        lambda trainer, started: {})
    monkeypatch.setattr(chip_smoke, "check_p15_preemption", lambda: {})
    monkeypatch.setattr(chip_smoke, "check_p15_integrity",
                        lambda a, model: setattr(chip_smoke.flash_attention,
                                                 "launches", 1))
    with pytest.raises(AssertionError, match="phase 15b"):
        chip_smoke.check_resilience()
