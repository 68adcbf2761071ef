"""chip_smoke.py's phase 19 (the training step's levers) rehearsed on the
CPU at a small size: vit_tiny (2 blocks, 32 px, dropout 0.1, batch 4)
for 19a, 19b and 19e with K1's plain version counted as the kernel counts
its launches, yolov3 at a quarter width and 64 px (batch 2) for 19c with
K2's the same way, resnet50_tpu cut to one block a stage at 32 px (batch
4) for 19d, and the classifier on the committed JPEG (PIL decodes here,
nvJPEG on the card). The card's sizes only on the card."""

import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.fixture
def tiny_p19(monkeypatch):
    from deepvision_tpu_torch import cli, configs
    from deepvision_tpu_torch.ops import attention, best_iou
    from deepvision_tpu_torch.serve import engine as engine_mod
    torch.set_num_threads(1)
    for module, name, counter in (
            (attention, "flash_attention_reference",
             chip_smoke.flash_attention),
            (best_iou, "best_iou_reference", chip_smoke.best_iou)):
        plain = getattr(module, name)

        def counted(*args, _plain=plain, _counter=counter, **kwargs):
            _counter.launches += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    real = configs.get_config

    def tiny(name):
        cfg = real(name)
        if name == "vit_tiny":
            return cfg.replace(model_kwargs={**cfg.model_kwargs, "depth": 2,
                                             "dropout_rate": 0.1})
        if name == "yolov3":
            return cfg.replace(model_kwargs={**cfg.model_kwargs,
                                             "width_mult": 0.25})
        if name == "resnet50_tpu":
            return cfg.replace(model_kwargs={"stage_sizes": (1, 1, 1, 1)},
                               data=dataclasses.replace(cfg.data,
                                                        image_size=32))
        return cfg

    for module in (configs, cli, chip_smoke, engine_mod):
        monkeypatch.setattr(module, "get_config", tiny)
    for name, value in (
            ("P19_DEVICE", "cpu"), ("P19_MODEL", "vit_tiny"),
            ("P19_BATCH", 4), ("P19_YOLO_SIZE", 64), ("P19_YOLO_BATCH", 2),
            ("P19_RESNET_BATCH", 4), ("P19_OVERFLOW_BYTES", 1000)):
        monkeypatch.setattr(chip_smoke, name, value)
    return tiny


def test_phase_19_rehearses_on_the_cpu(tiny_p19):
    out = chip_smoke.check_levers()
    depth = tiny_p19("vit_tiny").model_kwargs["depth"]
    steps = chip_smoke.P19_STEPS
    # the recompute runs every block's attention again
    assert out["19a"]["launches"] == {"plain": depth * steps,
                                      "remat": 2 * depth * steps}
    # on the CPU the recompute is the same arithmetic
    assert max(out["19a"]["rel"].values()) <= 1e-6
    assert out["19b"]["dispatches"] == 5
    assert out["19b"]["launches"] == depth * (10 + 2)
    assert out["19c"]["launches"] == 2 * 3 + 2 * 2
    assert out["19c"]["pulls"] == {1: 3, 10**6: 4}
    assert out["19c"]["overflow_launches"] == 3 + 2
    assert out["19d"]["rel"] == 0.0 and out["19d"]["spread"] == 0.0
    assert out["19e"]["launches"] == depth
    assert [n for n, _ in out["19e"]["top5"]] == \
        [n for n, _ in out["19e"]["served"]]


def test_a_wrong_launch_count_fails_phase_19(tiny_p19, monkeypatch):
    """19a holds K1's count under remat to the recompute's: a recompute
    that ran no attention fails the phase."""
    from deepvision_tpu_torch.core import train_state
    monkeypatch.setattr(train_state, "Remat", lambda model: model)
    with pytest.raises(AssertionError, match="19a: K1 launches"):
        chip_smoke.check_p19_remat(torch.device("cpu"))
