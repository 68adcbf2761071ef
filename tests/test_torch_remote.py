"""Remote paths (`deepvision_tpu_torch/data/fs.py`): TFRecords and a flat
ImageNet directory on fsspec's in-memory file system (`memory://`, no
network) read equal to the same files on disk, a builder's `--out` on
it, and a protocol whose package is absent (`gs://` without `gcsfs`)
refused by name before anything is contacted.
"""

import os
import sys
import uuid

import fsspec
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import torch_records_fixtures as fx  # noqa: E402
from deepvision_tpu_torch.data import detection as det  # noqa: E402
from deepvision_tpu_torch.data import fs, records  # noqa: E402
from deepvision_tpu_torch.data import imagenet as inet  # noqa: E402
from deepvision_tpu_torch.data.imagenet_flat import FlatImageNet  # noqa: E402


@pytest.fixture
def memory():
    """A fresh `memory://<bucket>` root, removed afterwards."""
    torch.set_num_threads(1)
    bucket = f"t{uuid.uuid4().hex[:12]}"
    mem = fsspec.filesystem("memory")
    yield f"memory://{bucket}"
    if mem.exists(f"/{bucket}"):
        mem.rm(f"/{bucket}", recursive=True)


def upload(local_root: str, url: str) -> None:
    mem, path = fsspec.core.url_to_fs(url)
    for dp, _, files in os.walk(local_root):
        for f in files:
            src = os.path.join(dp, f)
            rel = os.path.relpath(src, local_root).replace(os.sep, "/")
            with open(src, "rb") as fh:
                mem.pipe(f"{path}/{rel}", fh.read())


def same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y)
        assert all(torch.equal(s, t) for s, t in zip(x, y))


def test_imagenet_records_on_memory_read_equal_to_disk(tmp_path, memory):
    local = str(tmp_path / "inet")
    fx.write_imagenet(local, "train", [6, 5, 4], num_classes=10)
    fx.write_imagenet(local, "val", [5, 4], num_classes=10)
    upload(local, memory)
    for split, training in (("val", False), ("train", True)):
        on_disk = records.list_files(os.path.join(local, f"{split}*"),
                                     training=training, seed=3)
        remote = records.list_files(f"{memory}/{split}*", training=training,
                                    seed=3)
        assert [fs.basename(p) for p in remote] == [os.path.basename(p)
                                                    for p in on_disk]
        assert all(p.startswith("memory://") for p in remote)
        kw = dict(batch_size=3, image_size=32, training=training, seed=3)
        want = list(inet.epoch_iterator(inet.build_dataset(
            os.path.join(local, f"{split}*"), **kw), 3, 0))
        got = list(inet.epoch_iterator(inet.build_dataset(
            f"{memory}/{split}*", **kw), 3, 0))
        same_batches(want, got)


def test_detection_records_on_memory_read_equal_to_disk(tmp_path, memory):
    local = fx.write_voc(str(tmp_path / "voc"))
    upload(local, memory)
    kw = dict(batch_size=2, image_size=32, training=False)
    same_batches(list(det.build_dataset(os.path.join(local, "val*"), **kw)),
                 list(det.build_dataset(f"{memory}/val*", **kw)))


def test_flat_directory_on_memory_reads_equal_to_disk(tmp_path, memory):
    local = str(tmp_path / "flat")
    synsets = fx.write_flat(os.path.join(local, "train_flatten"), n=7)
    with open(os.path.join(local, "synsets.txt"), "w") as f:
        f.write("".join(f"{s}\n" for s in synsets))
    upload(local, memory)
    for training in (False, True):
        kw = dict(batch_size=3, image_size=32, training=training, seed=1)
        want = list(FlatImageNet(os.path.join(local, "train_flatten"),
                                 os.path.join(local, "synsets.txt"), **kw))
        got = list(FlatImageNet(f"{memory}/train_flatten",
                                f"{memory}/synsets.txt", **kw))
        same_batches(want, got)


def test_a_builder_writes_its_records_to_memory(tmp_path, memory):
    from test_torch_datasets import _voc_tree, assert_same_records
    from deepvision_tpu_torch.datasets import voc
    devkit = _voc_tree(str(tmp_path))
    voc.convert(devkit, str(tmp_path / "local"), 2, device="cpu",
                num_workers=1)
    voc.convert(devkit, f"{memory}/out", 2, device="cpu", num_workers=1)
    got = tmp_path / "fetched"
    got.mkdir()
    for url in fs.glob(f"{memory}/out/*"):
        with fs.open(url, "rb") as f:
            (got / fs.basename(url)).write_bytes(f.read())
    assert assert_same_records(str(tmp_path / "local"), str(got)) == 6


def test_a_protocol_without_its_package_is_refused_by_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "gcsfs", None)   # as if not installed
    for call in (lambda: records.list_files("gs://bucket/train*",
                                            training=False),
                 lambda: list(records.read_records("gs://bucket/train-0")),
                 lambda: FlatImageNet("gs://bucket/train_flatten",
                                      {"n01": 0}, batch_size=2)):
        with pytest.raises(fs.RemotePathError,
                           match=r"gs:// protocol needs the 'gcsfs' "
                                 r"package, which is not installed"):
            call()
    with pytest.raises(fs.RemotePathError, match="knows no protocol 'zz'"):
        records.list_files("zz://bucket/train*", training=False)


def test_a_remote_pattern_that_matches_nothing_raises(memory):
    with pytest.raises(FileNotFoundError, match="no files match"):
        records.list_files(f"{memory}/nothing*", training=False)
