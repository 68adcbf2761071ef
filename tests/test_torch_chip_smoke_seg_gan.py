"""chip_smoke.py's phase 14 (U-Net segmentation, checkpoint restore into
the engine, DCGAN, CycleGAN) rehearsed on the CPU at small sizes, the card
stood in for by the CPU (tests/test_torch_chip_smoke.py::_card_on_the_cpu):
the U-Net config's encoder cut to one Bottleneck a stage at width 8 and 32
px (a workdir's model_kwargs.json pins it for the restore), DCGAN at batch
8, CycleGAN with 2 blocks at 32 px; a yolov3_digits checkpoint at 64 px
stands in for phase 5's. The card-vs-CPU step checks are stood in for (they
need the card); test_p14_steps_run_in_f64 runs their steps in f64 on the
CPU. A kernel launch in any sub-phase fails the phase."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from test_torch_chip_smoke import _card_on_the_cpu  # noqa: E402

TINY_UNET = {"stage_sizes": [1, 1, 1, 1], "width": 8}


@pytest.fixture
def tiny_p14(monkeypatch, tmp_path):
    """Phase 14 at the small sizes above, on the CPU; returns phase 5's
    stand-in {"config", "workdir"}."""
    _card_on_the_cpu(monkeypatch)
    torch.set_num_threads(1)
    from deepvision_tpu_torch import cli, configs
    from deepvision_tpu_torch.core import gan as gan_mod
    from deepvision_tpu_torch.serve import engine as engine_mod

    monkeypatch.setattr(gan_mod, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    real_get = configs.get_config

    def tiny(name):
        cfg = real_get(name)
        if name != chip_smoke.P14_SEG_MODEL:
            return cfg
        return cfg.replace(model_kwargs=TINY_UNET, data=dataclasses.replace(
            cfg.data, image_size=32))

    for module in (chip_smoke, cli, engine_mod):
        monkeypatch.setattr(module, "get_config", tiny)
    params = sum(p.numel() for p in chip_smoke.build_model(
        tiny(chip_smoke.P14_SEG_MODEL)).parameters())
    for name, value in (("P14_SEG_PARAMS", params),
                        ("P14_SEG_SIZE", 32), ("P14_SEG_BATCH", 2),
                        ("P14_SEG_STEPS", 2), ("P14_F64_SIZE", 32),
                        ("P14_DCGAN_BATCH", 8), ("P14_DCGAN_STEPS", 2),
                        ("P14_DCGAN_SAMPLES", 5), ("P14_CG_SIZE", 32),
                        ("P14_CG_BATCH", 2), ("P14_CG_BLOCKS", 2),
                        ("YOLO_MODEL", "yolov3_digits")):
        monkeypatch.setattr(chip_smoke, name, value)
    workdir = str(tmp_path / "yolo")
    trainer, _ = cli.run_detection("YOLO", ["yolov3_digits"], [
        "-m", "yolov3_digits", "--synthetic", "--image-size", "64",
        "--batch-size", "2", "--steps-per-epoch", "1", "--epochs", "1",
        "--device", "cpu", "--workdir", workdir])
    return {"config": trainer.config, "workdir": workdir}


def test_phase_14_rehearses_on_the_cpu(monkeypatch, tiny_p14):
    """Every sub-phase end to end: the U-Net through UNet/torch/train.py
    with the paired augment and an EMA, its predict step; served from its
    workdir through build_server (provenance, masks equal to the predict
    step on the EMA weights, the CPU against itself: no pixel differs);
    yolov3_digits restored; DCGAN and CycleGAN trained, restored and
    sampled; the launch counts 0."""
    steps, gan_steps = [], []
    monkeypatch.setattr(chip_smoke, "check_step_against_f64",
                        lambda cfg, model, batch, name, what, make_step:
                        steps.append((name, len(batch))) or {})
    monkeypatch.setattr(chip_smoke, "gan_step_errors",
                        lambda run, what: gan_steps.append(what) or {})
    out = chip_smoke.check_segmentation_and_gans(tiny_p14)
    assert steps == [("14a unet_resnet50", 2)]
    assert [w.split(" ")[1] for w in gan_steps] == ["dcgan", "cyclegan",
                                                    "cyclegan"]
    seg = out["14a"]
    assert len(seg["losses"]) == 2 and seg["predict_ms"] > 0
    assert 0.0 <= seg["val"]["miou"] <= 1.0
    served = out["14b"]
    assert served["provenance"]["weights"] == "checkpoint"
    assert served["provenance"]["checkpoint_epoch"] == 1
    assert served["differ"] == 0 and served["logit_diff"] == 0.0
    assert served["pixels"] == (1 + 3 + 8) * 32 * 32
    assert served["mask_bytes"] == 32 * 32 * 4
    assert set(served["batch_ms"]) == {1, 8}
    assert len(out["14c"]["losses"]) == 2 and len(out["14d"]["losses"]) == 2
    assert (chip_smoke.flash_attention.launches,
            chip_smoke.best_iou.launches) == (0, 0)


@pytest.mark.parametrize("tag", ["14a", "14b", "14c", "14d"])
def test_a_kernel_launch_fails_phase_14(monkeypatch, tag):
    def run(*args):
        if run.tag == tag:
            chip_smoke.flash_attention.launches += 1
        return {}

    for sub, fn in (("14a", "check_segmentation_training"),
                    ("14b", "check_restored_serving"),
                    ("14c", "check_dcgan"), ("14d", "check_cyclegan")):
        def call(*args, _sub=sub):
            run.tag = _sub
            return run(*args)
        monkeypatch.setattr(chip_smoke, fn, call)
    with pytest.raises(AssertionError, match=f"phase {tag} path"):
        chip_smoke.check_segmentation_and_gans({})


def test_mask_agreement_counts_only_near_ties():
    """A served pixel that differs where the step's top two logits are
    within the gap is near; one that differs elsewhere is not."""
    logits = torch.tensor([[[[1.0, 0.99, 0.0], [2.0, 0.0, 0.0]]]])
    served = np.array([[[1, 1]]], np.int32)
    assert chip_smoke.mask_agreement(served, logits, 0.02) == (2, 1, 1)
    assert chip_smoke.mask_agreement(np.array([[[0, 0]]], np.int32),
                                     logits, 0.0) == (0, 0, 0)


@pytest.mark.parametrize("phase", ["dcgan", "cyclegan_gen", "cyclegan_disc"])
def test_p14_steps_run_in_f64(phase):
    """The GAN steps phase 14 holds card against CPU with: in f64 on the
    CPU they compute f64 gradients on every parameter, and two runs give
    equal losses, gradients and BatchNorm statistics under the comparison
    (`gan_step_diffs`) whose bounds the card's run must meet."""
    torch.set_num_threads(1)
    if phase == "dcgan":
        run = chip_smoke.dcgan_step_run()
    else:
        runs = chip_smoke.cyclegan_step_runs(16, 1)
        run = runs[0] if phase == "cyclegan_gen" else runs[1]
    cpu = torch.device("cpu")
    first, second = run(cpu, torch.float64), run(cpu, torch.float64)
    assert chip_smoke.gan_step_diffs(second, first) == {
        "loss": 0.0, "grad": 0.0, "stats": 0.0}
    losses, states = first
    assert all(np.isfinite(v) for v in losses.values())
    assert all(p.dtype == torch.float64 and p.grad is not None
               for st in states[:1 if phase == "cyclegan_gen" else None]
               for p in st.model.parameters())
    if phase == "cyclegan_gen":
        # the discriminators ran in train mode in the generator phase: their
        # BatchNorm statistics moved, and are compared
        d = states[1].model.state_dict()
        assert any(not torch.equal(d[k], torch.zeros_like(d[k]))
                   for k in d if k.endswith("running_mean"))


def test_gan_step_diffs_see_a_perturbed_statistic():
    torch.set_num_threads(1)
    run_gen, _ = chip_smoke.cyclegan_step_runs(16, 1)
    cpu = torch.device("cpu")
    ref, got = run_gen(cpu, torch.float64), run_gen(cpu, torch.float64)
    bn = got[1][1].model["a"].bns[0]
    bn.running_var.mul_(1.5)
    assert chip_smoke.gan_step_diffs(got, ref)["stats"] > 0.1
