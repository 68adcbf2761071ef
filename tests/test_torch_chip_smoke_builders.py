"""chip_smoke.py's phase 18 raw trees and builders rehearsed on the CPU at
a small size: the seeded ILSVRC, VOCdevkit, MPII, COCO and CycleGAN trees
(PIL encodes where the card's nvJPEG would), the port's builders over
them (`python -m deepvision_tpu_torch.datasets.voc2007` as a subprocess,
the others in process), each builder's counts, and the re-encodes of the
committed gray JPEG and PNG equal to PIL's (`<name>.pil95.jpg`: on the
CPU the builders re-encode with PIL). The JAX builders take the same
trees and write the same records."""

import importlib.util
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
import chip_smoke  # noqa: E402
from test_torch_datasets import assert_same_records  # noqa: E402

SMALL = (("P18_DEVICE", "cpu"), ("P18_SIZES", ((30, 40), (40, 30))),
         ("P18_UNIQUE", 8), ("P18_INET_TRAIN", 12), ("P18_INET_VAL", 3),
         ("P18_SYNSETS", 3), ("P18_YOLO_BATCH", 2), ("P18_YOLO_STEPS", 2),
         ("P18_YOLO_VAL", 3), ("P18_POSE_BATCH", 2), ("P18_POSE_STEPS", 2),
         ("P18_POSE_VAL", 4), ("P18_CG_BATCH", 2), ("P18_CG_STEPS", 2),
         ("P18_COCO_TRAIN", 3), ("P18_COCO_VAL", 3))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    for name, value in SMALL:
        mp.setattr(chip_smoke, name, value)
    root = str(tmp_path_factory.mktemp("p18"))
    try:
        yield root, chip_smoke.p18_datasets(root, torch.device("cpu"))
    finally:
        mp.undo()


def test_trees_and_builders_rehearse_on_the_cpu(built):
    root, paths = built
    b = paths["builders"]
    assert b["imagenet"]["records"] == 12 + 2 + 3
    assert b["imagenet"]["files"] == 2 + 1
    assert b["voc2007"]["records"] == 2 * 2 + 3
    assert b["voc2007"]["files"] == 2 * 2          # NUM_SHARDS a split
    assert b["mpii"]["records"] == 2 * 2 + 2 + 4
    assert b["mpii"]["files"] == 64 + 8
    assert b["coco"]["records"] == 3 + 2 + 3 and b["coco"]["files"] == 72
    assert b["cyclegan"]["records"] == 2 * (2 * 2 + 1)
    assert all(v["bytes"] > 0 and v["images_per_sec"] > 0
               for v in b.values())
    # on the CPU the builders' re-encodes are PIL's, byte for byte
    assert len(paths["reencode"]) == 8
    assert all(v == (0, 0.0) for v in paths["reencode"].values())


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_jax_builders_take_the_same_trees(built, tmp_path, monkeypatch):
    root, paths = built
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    raw = os.path.join(root, "raw")
    from Datasets.voc import convert as jax_voc
    jax_voc(os.path.join(raw, "voc", "VOCdevkit", "VOC2007"),
            str(tmp_path / "voc"), 2)
    assert_same_records(str(tmp_path / "voc"), paths["voc"])
    jax_mpii = _load(os.path.join(REPO, "Datasets", "MPII",
                                  "tfrecords_mpii.py"), "jax_mpii_p18")
    jax_mpii.convert(os.path.join(raw, "mpii", "mpii_human_pose_v1_u12_2"),
                     os.path.join(raw, "mpii", "mpii", "images"),
                     str(tmp_path / "mpii"))
    assert_same_records(str(tmp_path / "mpii"), paths["mpii"])
    jax_coco = _load(os.path.join(REPO, "Datasets", "MSCOCO",
                                  "tfrecords.py"), "jax_coco_p18")
    jax_coco.convert(os.path.join(raw, "coco", "annotations"),
                     str(tmp_path / "coco"), "2017",
                     os.path.join(raw, "coco"))
    assert_same_records(str(tmp_path / "coco"), paths["coco"])
    jax_inet = _load(os.path.join(REPO, "Datasets", "ILSVRC2012",
                                  "build_imagenet_tfrecord.py"),
                     "jax_inet_p18")
    r = os.path.join(raw, "imagenet")
    monkeypatch.setattr(sys, "argv", [
        "build", "--train_directory", os.path.join(r, "train"),
        "--validation_directory", os.path.join(r, "validation"),
        "--output_directory", str(tmp_path / "inet"),
        "--labels_file", os.path.join(r, "synsets.txt"),
        "--imagenet_metadata_file", os.path.join(r, "metadata.txt"),
        "--validation_labels_file", os.path.join(r, "val_labels.txt"),
        "--train_shards", "2", "--validation_shards", "1",
        "--num_workers", "1"])
    jax_inet.main()
    assert_same_records(str(tmp_path / "inet"), paths["inet"])


def test_a_failing_builder_fails_phase_18(tmp_path, monkeypatch):
    """The VOC subprocess's failure fails the phase, naming the command."""
    for name, value in SMALL:
        monkeypatch.setattr(chip_smoke, name, value)
    real = chip_smoke.p18_tree_voc

    def broken(root, device):
        devkit = real(root, device)
        os.remove(os.path.join(devkit, "JPEGImages", "000000.jpg"))
        return devkit

    monkeypatch.setattr(chip_smoke, "p18_tree_voc", broken)
    with pytest.raises(AssertionError, match="datasets.voc2007 .* exited 1"):
        chip_smoke.p18_datasets(str(tmp_path), torch.device("cpu"))
