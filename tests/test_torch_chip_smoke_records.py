"""chip_smoke.py's phase 18 (real datasets from records) rehearsed on the
CPU at a small size: the records written by the port's builders from
seeded raw trees (PIL encodes where the card's nvJPEG would; the trees
and builders alone: test_torch_chip_smoke_builders.py), the decoder
against the committed fixtures' goldens (PIL is their golden: exact
here), the resample against its plain version, resnet50_tpu from the
ImageNet records under --device-augment and --device-normalize
--cache-val (0 bytes staged by the prefetcher; the cached val pipeline),
vit_small with --profile-dir and K1's plain version counted as the kernel
counts its launches, yolov3 --num-classes 20 with K2's the same way,
--eval-only through a file:// URL, and evaluate.py on a yolov3 checkpoint
over the COCO records, hourglass104 (2 stacks of order 2, at a
sixteenth of the width, batch 4) and evaluate.py on its split, and
cyclegan: every entry point at 64 px (cyclegan 64), the card's sizes
only on the card."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TINY_POSE = dict(num_stack=2, order=2, width_mult=1 / 16)


@pytest.fixture
def tiny_p18(monkeypatch):
    from deepvision_tpu_torch import cli, configs
    from deepvision_tpu_torch.ops import attention, best_iou
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
        if name == "hourglass104":
            cfg = cfg.replace(model_kwargs={**cfg.model_kwargs, **TINY_POSE},
                              batch_size=4)
        return cfg

    for module in (configs, cli, chip_smoke):
        monkeypatch.setattr(module, "get_config", tiny)
    for name, value in (
            ("P18_DEVICE", "cpu"), ("P18_SIZE", 64),
            ("P18_SIZES", ((30, 40), (40, 30))), ("P18_UNIQUE", 8),
            ("P18_INET_TRAIN", 12), ("P18_INET_VAL", 3),
            ("P18_DECODE_BATCH", 8), ("P18_DECODE_REPS", 1),
            ("P18_RESNET_BATCH", 3), ("P18_RESNET_STEPS", 2),
            ("P18_LOADER_BATCHES", 1), ("P18_YOLO_BATCH", 2),
            ("P18_YOLO_STEPS", 2), ("P18_YOLO_VAL", 3),
            ("P18_POSE_BATCH", 2), ("P18_POSE_STEPS", 2),
            ("P18_POSE_VAL", 4), ("P18_CG_BATCH", 2), ("P18_CG_STEPS", 2),
            ("P18_SYNSETS", 3), ("P18_COCO_TRAIN", 3), ("P18_COCO_VAL", 3),
            # the plain version's softmax stands in the CPU's profile for
            # K1's kernel
            ("P18_K1_KERNEL", "softmax")):
        monkeypatch.setattr(chip_smoke, name, value)


@pytest.fixture
def yolo_workdir(tmp_path):
    """A yolov3 checkpoint at 64 px and 80 classes (phase 5's, small)."""
    wd = str(tmp_path / "yolo")
    chip_smoke.run_detection("YOLO", ["yolov3"], [
        "-m", "yolov3", "--synthetic", "--image-size", "64",
        "--batch-size", "2", "--steps-per-epoch", "1", "--epochs", "1",
        "--device", "cpu", "--workdir", wd])
    return wd


def test_phase_18_rehearses_on_the_cpu(tiny_p18, yolo_workdir):
    out = chip_smoke.check_real_datasets(yolo_workdir)
    assert all(r["pil"][0] == 0 for r in out["18a"]["fixtures"])
    assert max(out["18a"]["resample_err"].values()) == 0.0
    for flag in ("--device-augment", "--device-normalize"):
        rec = out["18b"][flag]
        assert rec["staged_bytes"] == 0 and rec["compressed_bytes"] > 0
    depth = chip_smoke.get_config("vit_small").model_kwargs["depth"]
    assert out["18c"]["launches"] == depth * (2 + 1)
    assert out["18d"]["launches"] == 2 + 1 and out["18d"]["eval_images"] == 3
    assert out["18d"]["eval_only_launches"] == 1
    assert out["18b"]["cache_val"]["opened"] == 1
    assert all(v == (0, 0.0) for v in out["reencode"].values())
    assert out["18e"]["pose_steps"] == 2 and out["18e"]["cyclegan_steps"] == 2


def test_a_wrong_launch_count_fails_phase_18(tiny_p18, monkeypatch,
                                             tmp_path):
    """18c holds K1's count to depth x (steps + eval batches): one launch
    more fails the phase."""
    entry = chip_smoke.p18_entry

    def one_more(*args, **kwargs):
        got = entry(*args, **kwargs)
        chip_smoke.flash_attention.launches += 1
        return got

    monkeypatch.setattr(chip_smoke, "p18_entry", one_more)
    paths = chip_smoke.p18_datasets(str(tmp_path), torch.device("cpu"))
    with pytest.raises(AssertionError, match="K1 launches"):
        chip_smoke.check_records_vit(paths, torch.device("cpu"))
