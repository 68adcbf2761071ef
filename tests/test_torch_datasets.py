"""The port's dataset builders (`deepvision_tpu_torch/datasets/`) against
the JAX package's (`Datasets/`, `CycleGAN/jax/{tfrecords,celeba}.py`) on
the same seeded raw trees, on the CPU: the same shard names and counts,
the same record order, and every feature equal after both files are
parsed by `data/records.py` — bytes byte for byte (PIL's re-encodes of
the gray, CMYK and PNG sources included), floats bit for bit, integers
exactly. The flattened and CelebA trees are compared file for file, the
boxes CSV line for line. Fixture recipes follow tests/test_datasets.py.
"""

import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from deepvision_tpu_torch.data import records  # noqa: E402
from deepvision_tpu_torch.datasets import (celeba, coco,  # noqa: E402
                                           common, cyclegan, imagenet,
                                           imagenet_boxes, imagenet_flatten,
                                           images, mpii, voc, voc2007,
                                           voc2012)
from torch_records_fixtures import natural_image  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    torch.set_num_threads(1)
    # the JAX builders size their pools from os.cpu_count(): one worker
    # keeps them in this process (TensorFlow is not forked)
    monkeypatch.setattr(os, "cpu_count", lambda: 1)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- raw sources -------------------------------------------------------------

def _save(path, image, fmt, **opts):
    from PIL import Image
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(image).save(path, fmt, **opts)


def _source(path, kind, rs, size=(30, 40)):
    """One source image of `kind`: rgb (4:2:0 JPEG), gray and cmyk JPEGs,
    png (RGB), rgba and palette PNGs, or png_as_jpeg (a PNG named .JPEG,
    as ILSVRC2012's n02105855_2933.JPEG)."""
    from PIL import Image
    h, w = size
    img = natural_image(h, w, rs)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if kind == "rgb":
        _save(path, img, "JPEG", quality=90)
    elif kind == "gray":
        _save(path, img[..., 0], "JPEG", quality=90)
    elif kind == "cmyk":
        Image.fromarray(np.concatenate([img, img[..., :1]], -1),
                        "CMYK").save(path, "JPEG", quality=90)
    elif kind in ("png", "png_as_jpeg"):
        _save(path, img, "PNG")
    elif kind == "rgba":
        _save(path, np.concatenate([img, img[..., :1]], -1), "PNG")
    elif kind == "palette":
        Image.fromarray(img).quantize(64).save(path, "PNG")
    else:
        raise ValueError(kind)


# -- comparing outputs -------------------------------------------------------

def _features(path):
    return [records.parse_example(r) for r in records.read_records(path)]


def _equal_feature(a, b):
    if a.kind != b.kind:
        return False
    if a.kind == "bytes":
        return list(a.values) == list(b.values)
    return (a.values.dtype == b.values.dtype
            and np.array_equal(a.values.view(np.uint8),
                               b.values.view(np.uint8)))


def assert_same_records(want_dir, got_dir):
    """The same files, records in the same order, every feature equal
    (floats bit for bit)."""
    want = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == want
    n = 0
    for name in want:
        w, g = (_features(os.path.join(d, name)) for d in (want_dir, got_dir))
        assert len(w) == len(g), name
        for i, (fw, fg) in enumerate(zip(w, g)):
            assert sorted(fw) == sorted(fg), (name, i)
            for key in fw:
                assert _equal_feature(fw[key], fg[key]), (name, i, key)
            n += 1
    return n


def assert_same_tree(want_dir, got_dir):
    def walk(root):
        out = {}
        for dp, _, files in os.walk(root):
            for f in files:
                p = os.path.join(dp, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
        return out
    w, g = walk(want_dir), walk(got_dir)
    assert sorted(g) == sorted(w)
    assert all(g[k] == w[k] for k in w)
    return len(w)


# -- VOC ---------------------------------------------------------------------

def _voc_tree(root, n=6, seed=0, splits=("train", "val", "test")):
    rs = np.random.RandomState(seed)
    devkit = os.path.join(root, "VOCdevkit", "VOC2007")
    for d in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                         "Main")):
        os.makedirs(os.path.join(devkit, d), exist_ok=True)
    names = ["dog", "person", "car", "cat", "tvmonitor"]
    ids = {s: [] for s in splits}
    for i in range(n):
        name = f"{i:06d}"
        h, w = (37 + 3 * i, 51 - 2 * i)
        _source(os.path.join(devkit, "JPEGImages", f"{name}.jpg"), "rgb",
                rs, (h, w))
        objs = "".join(
            f"<object><name>{names[(i + k) % len(names)]}</name>"
            f"{'<difficult>1</difficult>' if k == 1 else ''}"
            f"<bndbox><xmin>{1 + k}</xmin><ymin>{2 + k}</ymin>"
            f"<xmax>{w - 3 * k}</xmax><ymax>{h - k}.7</ymax></bndbox>"
            f"</object>" for k in range(1 + i % 3))
        with open(os.path.join(devkit, "Annotations", f"{name}.xml"),
                  "w") as f:
            f.write(f"<annotation><filename>{name}.jpg</filename><size>"
                    f"<width>{w}</width><height>{h}</height><depth>"
                    f"{1 if i == 4 else 3}</depth></size>{objs}"
                    f"</annotation>")
        ids[splits[i % len(splits)]].append(name)
    # an annotation in no split is reported and left out
    with open(os.path.join(devkit, "Annotations", "999999.xml"), "w") as f:
        f.write("<annotation><filename>999999.jpg</filename><size><width>"
                "9</width><height>9</height><depth>3</depth></size>"
                "</annotation>")
    for s, names_ in ids.items():
        with open(os.path.join(devkit, "ImageSets", "Main", f"{s}.txt"),
                  "w") as f:
            f.write("\n".join(names_) + "\n")
    return devkit


@pytest.mark.parametrize("shards,workers", [(2, 1), (3, 2)],
                         ids=["in_process", "spawn_pool"])
def test_voc_records_equal_jax(tmp_path, shards, workers):
    from Datasets.voc import convert as jax_convert
    devkit = _voc_tree(str(tmp_path))
    want = jax_convert(devkit, str(tmp_path / "jax"), shards)
    got = voc.convert(devkit, str(tmp_path / "port"), shards, device="cpu",
                      num_workers=workers)
    assert got == want == 6
    assert len(os.listdir(tmp_path / "port")) == 3 * shards
    assert assert_same_records(str(tmp_path / "jax"),
                               str(tmp_path / "port")) == 6


@pytest.mark.parametrize("module,year,shards,splits", [
    (voc2007, "2007", 2, ("train", "val", "test")),
    (voc2012, "2012", 4, ("train", "val"))])
def test_voc_command_lines_keep_the_jax_flags(tmp_path, monkeypatch, module,
                                              year, shards, splits):
    """Each script's flags and defaults letter for letter (run from the
    directory holding ./VOCdevkit/VOC<year>), NUM_SHARDS included."""
    jax_script = _load(os.path.join(REPO, "Datasets", f"VOC{year}",
                                    "tfrecords.py"), f"jax_voc{year}")
    assert module.NUM_SHARDS == jax_script.NUM_SHARDS == shards
    devkit = _voc_tree(str(tmp_path), n=8, splits=splits)
    os.rename(devkit, str(tmp_path / "VOCdevkit" / f"VOC{year}"))
    monkeypatch.chdir(tmp_path)
    assert module.main(["--device", "cpu"]) == 8
    out = "tfrecords_voc" + ("" if year == "2007" else year)
    assert sorted(os.listdir(tmp_path / out)) == sorted(
        f"{s}_{i:04d}_of_{shards:04d}.tfrecords" for s in splits
        for i in range(1, shards + 1))
    from Datasets.voc import convert as jax_convert
    jax_convert(f"./VOCdevkit/VOC{year}", "./jax", shards, splits=splits)
    assert_same_records(str(tmp_path / "jax"), str(tmp_path / out))


def test_voc_box_outside_the_image_is_refused(tmp_path):
    devkit = _voc_tree(str(tmp_path), n=1, splits=("train",))
    xml = os.path.join(devkit, "Annotations", "000000.xml")
    with open(xml) as f:
        text = f.read()
    with open(xml, "w") as f:
        f.write(text.replace("<xmax>51</xmax>", "<xmax>52</xmax>"))
    with pytest.raises(ValueError, match="outside the image"):
        voc.convert(devkit, str(tmp_path / "out"), 1, splits=("train",))


# -- MPII and COCO -----------------------------------------------------------

def _mpii_tree(root, seed=1):
    rs = np.random.RandomState(seed)
    img_dir = os.path.join(root, "mpii", "images")
    ann_dir = os.path.join(root, "mpii_human_pose_v1_u12_2")
    os.makedirs(ann_dir, exist_ok=True)
    kinds = ["rgb", "gray", "png", "rgb", "cmyk", "rgba", "palette", "rgb"]
    annos = {"train.json": [], "validation.json": []}
    for i, kind in enumerate(kinds):
        name = f"{i:03d}.{'png' if kind in ('png', 'rgba', 'palette') else 'jpg'}"
        h, w = 41 + i, 57 - i
        _source(os.path.join(img_dir, name), kind, rs, (h, w))
        joints = [[float(rs.uniform(0, w)), float(rs.uniform(0, h))]
                  if rs.rand() > 0.2 else [-1, -1] for _ in range(16)]
        joints[0] = [int(w // 2), int(h // 3)]          # integer joints
        vis = [int(v) for v in rs.randint(0, 3, 16)]
        annos["train.json" if i < 5 else "validation.json"].append(
            {"image": name, "joints": joints, "joints_vis": vis})
    for fname, rows in annos.items():
        with open(os.path.join(ann_dir, fname), "w") as f:
            json.dump(rows, f)
    return ann_dir, img_dir


def test_mpii_records_equal_jax(tmp_path):
    jax_mpii = _load(os.path.join(REPO, "Datasets", "MPII",
                                  "tfrecords_mpii.py"), "jax_mpii")
    assert (mpii.NUM_TRAIN_SHARDS, mpii.NUM_VAL_SHARDS) == (
        jax_mpii.NUM_TRAIN_SHARDS, jax_mpii.NUM_VAL_SHARDS) == (64, 8)
    ann_dir, img_dir = _mpii_tree(str(tmp_path))
    assert jax_mpii.convert(ann_dir, img_dir, str(tmp_path / "jax")) == 8
    assert mpii.convert(ann_dir, img_dir, str(tmp_path / "port"),
                        device="cpu") == 8
    assert len(os.listdir(tmp_path / "port")) == 64 + 8
    assert assert_same_records(str(tmp_path / "jax"),
                               str(tmp_path / "port")) == 8


def _coco_tree(root, seed=2):
    rs = np.random.RandomState(seed)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    cats = [{"id": 18, "name": "dog"}, {"id": 1, "name": "person"},
            {"id": 3, "name": "car"}]
    kinds = {"train": ["rgb", "gray", "png", "rgb", "cmyk"],
             "val": ["rgb", "palette", "rgb"]}
    for split, ks in kinds.items():
        annos, ids = [], []
        for i, kind in enumerate(ks):
            iid = 1000 * (split == "val") + 7 * i + 3
            h, w = 33 + i, 45 + 2 * i
            _source(os.path.join(root, f"{split}2017",
                                 f"{str(iid).rjust(12, '0')}.jpg"), kind,
                    rs, (h, w))
            for k in range(1 + i % 3):
                x, y = float(rs.uniform(-1, w / 2)), float(rs.uniform(0, h))
                annos.append({"image_id": iid, "category_id":
                              cats[(i + k) % 3]["id"],
                              "bbox": [x, y, float(rs.uniform(1, w)),
                                       float(rs.uniform(1, h))]})
            ids.append(iid)
        rs.shuffle(annos)
        with open(os.path.join(ann_dir, f"instances_{split}2017.json"),
                  "w") as f:
            json.dump({"categories": cats, "annotations": annos,
                       "images": [{"id": i} for i in ids]}, f)
    return ann_dir


def test_coco_records_equal_jax(tmp_path, monkeypatch):
    jax_coco = _load(os.path.join(REPO, "Datasets", "MSCOCO",
                                  "tfrecords.py"), "jax_coco")
    assert (coco.NUM_TRAIN_SHARDS, coco.NUM_VAL_SHARDS) == (64, 8)
    ann_dir = _coco_tree(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    assert jax_coco.convert(ann_dir, str(tmp_path / "jax"), "2017",
                            str(tmp_path)) == 8
    # the command line, as a user runs it from the dataset's root
    assert coco.main(["--out", str(tmp_path / "port"), "--device",
                      "cpu"]) == 8
    assert assert_same_records(str(tmp_path / "jax"),
                               str(tmp_path / "port")) == 8


# -- ImageNet: records, flatten, boxes -----------------------------------------

SYNSETS = ["n01440764", "n01443537", "n02105855"]


def _imagenet_tree(root, seed=3):
    rs = np.random.RandomState(seed)
    train = os.path.join(root, "train")
    kinds = ["rgb", "rgb", "gray", "png_as_jpeg", "cmyk", "rgb", "palette",
             "rgb", "rgba"]
    for i, kind in enumerate(kinds):
        synset = SYNSETS[i % len(SYNSETS)]
        name = (f"{synset}_{i}.JPEG" if i % 4 else f"{i}.JPEG")
        _source(os.path.join(train, synset, name), kind, rs,
                (31 + 2 * i, 43 - i))
    val = os.path.join(root, "validation")
    for i, kind in enumerate(["rgb", "gray", "rgb", "png"]):
        _source(os.path.join(val, f"ILSVRC2012_val_{i + 1:08d}.JPEG"), kind,
                rs)
    with open(os.path.join(root, "synsets.txt"), "w") as f:
        f.write("\n".join(SYNSETS) + "\n")
    with open(os.path.join(root, "meta.txt"), "w") as f:
        f.write(f"{SYNSETS[0]}\ttench, Tinca tinca\n{SYNSETS[1]}\tgoldfish"
                f"\nbroken line without a tab\n")
    with open(os.path.join(root, "val_labels.txt"), "w") as f:
        f.write("\n".join([SYNSETS[2], SYNSETS[0], SYNSETS[0], SYNSETS[1]])
                + "\n")
    return root


def _imagenet_argv(root, out, workers):
    return ["--train_directory", os.path.join(root, "train"),
            "--validation_directory", os.path.join(root, "validation"),
            "--output_directory", out,
            "--labels_file", os.path.join(root, "synsets.txt"),
            "--imagenet_metadata_file", os.path.join(root, "meta.txt"),
            "--validation_labels_file", os.path.join(root, "val_labels.txt"),
            "--train_shards", "3", "--validation_shards", "2",
            "--num_workers", str(workers)]


def test_imagenet_records_equal_jax(tmp_path, monkeypatch):
    """The shuffle (random.Random(12345)), the 1-indexed labels, the human
    map and the PIL re-encodes of the gray, CMYK and PNG sources."""
    root = _imagenet_tree(str(tmp_path))
    jax_inet = _load(os.path.join(REPO, "Datasets", "ILSVRC2012",
                                  "build_imagenet_tfrecord.py"), "jax_inet")
    assert (imagenet.NUM_TRAIN_SHARDS, imagenet.NUM_VAL_SHARDS) == (
        jax_inet.NUM_TRAIN_SHARDS, jax_inet.NUM_VAL_SHARDS) == (1024, 128)
    monkeypatch.setattr(sys, "argv", ["build"] + _imagenet_argv(
        root, str(tmp_path / "jax"), 1))
    jax_inet.main()
    imagenet.main(_imagenet_argv(root, str(tmp_path / "port"), 1)
                  + ["--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "port")) == [
        "train-00000-of-00003", "train-00001-of-00003",
        "train-00002-of-00003", "validation-00000-of-00002",
        "validation-00001-of-00002"]
    assert assert_same_records(str(tmp_path / "jax"),
                               str(tmp_path / "port")) == 9 + 4
    labels = sorted(int(f["image/class/label"].values[0])
                    for name in os.listdir(tmp_path / "port")
                    for f in _features(str(tmp_path / "port" / name)))
    assert labels == sorted([1, 2, 3] * 3 + [3, 1, 1, 2])


def test_imagenet_spawn_pool_writes_the_same_shards(tmp_path):
    root = _imagenet_tree(str(tmp_path))
    imagenet.main(_imagenet_argv(root, str(tmp_path / "one"), 1)
                  + ["--device", "cpu"])
    imagenet.main(_imagenet_argv(root, str(tmp_path / "two"), 2)
                  + ["--device", "cpu"])
    assert assert_same_records(str(tmp_path / "one"),
                               str(tmp_path / "two")) == 13


def test_imagenet_validation_count_mismatch_is_refused(tmp_path):
    root = _imagenet_tree(str(tmp_path))
    with open(os.path.join(root, "val_labels.txt"), "a") as f:
        f.write(SYNSETS[0] + "\n")
    with pytest.raises(ValueError, match="4 validation images but 5"):
        imagenet.main(_imagenet_argv(root, str(tmp_path / "out"), 1)
                      + ["--device", "cpu"])


def test_flatten_trees_equal_jax(tmp_path):
    jax_flat = _load(os.path.join(REPO, "Datasets", "ILSVRC2012",
                                  "flatten.py"), "jax_flatten")
    root = _imagenet_tree(str(tmp_path / "src"))
    for copy in (True, False):
        tag = "copy" if copy else "link"
        want = jax_flat.flatten_train(os.path.join(root, "train"),
                                      str(tmp_path / f"jt_{tag}"), copy)
        got = imagenet_flatten.flatten_train(
            os.path.join(root, "train"), str(tmp_path / f"pt_{tag}"), copy)
        assert got == want == 9
        assert assert_same_tree(str(tmp_path / f"jt_{tag}"),
                                str(tmp_path / f"pt_{tag}")) == 9
    jax_flat.flatten_val(os.path.join(root, "validation"),
                         os.path.join(root, "val_labels.txt"),
                         str(tmp_path / "jv"), True)
    assert imagenet_flatten.main(
        ["--val-dir", os.path.join(root, "validation"), "--val-labels",
         os.path.join(root, "val_labels.txt"), "--out",
         str(tmp_path / "pv"), "--copy"]) == 4
    assert assert_same_tree(str(tmp_path / "jv"), str(tmp_path / "pv")) == 4
    with pytest.raises(SystemExit, match="--val-dir requires --val-labels"):
        imagenet_flatten.main(["--val-dir", "x", "--out", "y"])


def test_boxes_csv_equals_jax(tmp_path, capsys):
    xml = """<annotation><filename>{name}</filename>
      <size><width>{w}</width><height>{h}</height></size>{objs}
    </annotation>"""
    box = ("<object><bndbox><xmin>{}</xmin><ymin>{}</ymin><xmax>{}</xmax>"
           "<ymax>{}</ymax></bndbox></object>")
    rs = np.random.RandomState(4)
    for synset in SYNSETS + ["n99999999"]:
        d = tmp_path / synset
        d.mkdir()
        for k in range(3):
            w, h = int(rs.randint(50, 300)), int(rs.randint(50, 300))
            # some boxes overhang the image, some are inverted (dropped)
            objs = ""
            for _ in range(3):
                x1, y1 = rs.uniform(-0.1, 0.7, 2) * (w, h)
                x2, y2 = (x1, y1) + rs.uniform(-0.1, 0.6, 2) * (w, h)
                objs += box.format(x1, y1, x2, y2)
            (d / f"{k}.xml").write_text(xml.format(
                name=f"{synset}_{k}", w=w, h=h, objs=objs))
    synsets = tmp_path / "synsets.txt"
    synsets.write_text("\n".join(SYNSETS) + "\n")
    jax_boxes = _load(os.path.join(REPO, "Datasets", "ILSVRC2012",
                                   "process_bounding_boxes.py"), "jax_boxes")
    for extra in ([], [str(synsets)]):
        argv = sys.argv
        sys.argv = ["pbb", str(tmp_path)] + extra
        try:
            jax_boxes.main()
        finally:
            sys.argv = argv
        want = capsys.readouterr()
        n = imagenet_boxes.main([str(tmp_path)] + extra)
        got = capsys.readouterr()
        assert got.out.splitlines() == want.out.splitlines()
        assert got.err == want.err and n == len(want.out.splitlines()) > 0


# -- CycleGAN and CelebA ------------------------------------------------------

def _cyclegan_tree(root, seed=5):
    rs = np.random.RandomState(seed)
    kinds = {"trainA": ["rgb", "gray", "png", "rgb"],
             "trainB": ["rgb", "cmyk", "rgba", "palette"],
             "testA": ["rgb"]}
    for split, ks in kinds.items():
        for i, kind in enumerate(ks):
            _source(os.path.join(root, "toy", split, f"{i}.img"), kind, rs,
                    (28 + i, 36 - i))
    # not an image: skipped with a warning
    with open(os.path.join(root, "toy", "trainA", "notes.txt"), "w") as f:
        f.write("not an image")
    return root


def test_cyclegan_records_equal_jax(tmp_path, monkeypatch, capsys):
    root = _cyclegan_tree(str(tmp_path / "datasets"))
    jax_cg = _load(os.path.join(REPO, "CycleGAN", "jax", "tfrecords.py"),
                   "jax_cyclegan_tfrecords")
    monkeypatch.setattr(sys, "argv", [
        "tfrecords", "--dataset", "toy", "--data-root", root, "--out-root",
        str(tmp_path / "jax")])
    jax_cg.main()
    want = capsys.readouterr().out
    written = cyclegan.main(["--dataset", "toy", "--data-root", root,
                             "--out-root", str(tmp_path / "port"),
                             "--device", "cpu"])
    got = capsys.readouterr().out
    assert written == {"trainA": 4, "trainB": 4, "testA": 1}
    assert "WARNING: skipping" in got and "notes.txt" in got
    assert [ln for ln in got.splitlines() if ln.startswith("Finished")] == \
        [ln for ln in want.splitlines() if ln.startswith("Finished")]
    assert assert_same_records(str(tmp_path / "jax" / "toy"),
                               str(tmp_path / "port" / "toy")) == 9


def test_celeba_split_equals_jax(tmp_path, monkeypatch):
    rs = np.random.RandomState(6)
    imgs = tmp_path / "img_align_celeba"
    names = [f"{i:06d}.jpg" for i in range(1, 6)]
    for name in names:
        _source(str(imgs / name), "rgb", rs)
    header = "5_o_Clock_Shadow Arched_Eyebrows Male Young"
    rows = [f"{n} {' '.join(str(int(v)) for v in rs.choice([-1, 1], 4))}"
            for n in names]
    (tmp_path / "attrs.txt").write_text(f"5\n{header}\n" + "\n".join(rows)
                                        + "\n\n")
    jax_celeba = _load(os.path.join(REPO, "CycleGAN", "jax", "celeba.py"),
                       "jax_celeba")
    monkeypatch.setattr(sys, "argv", [
        "celeba", "--attrs", str(tmp_path / "attrs.txt"), "--images",
        str(imgs), "--out", str(tmp_path / "jax")])
    jax_celeba.main()
    n = celeba.main(["--attrs", str(tmp_path / "attrs.txt"), "--images",
                     str(imgs), "--out", str(tmp_path / "port")])
    assert n["trainA"] + n["trainB"] == 5
    assert assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port")) \
        == 5


# -- the pieces ----------------------------------------------------------------

def test_chunkify_and_shard_names_equal_jax():
    from Datasets import common as jax_common
    for n_items, n in ((10, 3), (5, 64), (0, 2), (7, 7)):
        items = list(range(n_items))
        assert common.chunkify(items, n) == jax_common.chunkify(items, n)
    assert common.shard_path("out", "train", 3, 64) == \
        jax_common.shard_path("out", "train", 3, 64)
    jax_inet = _load(os.path.join(REPO, "Datasets", "ILSVRC2012",
                                  "build_imagenet_tfrecord.py"), "jax_inet2")
    assert imagenet.tf_official_shard_path("o", "train", 5, 1024) == \
        jax_inet._tf_official_shard_path("o", "train", 5, 1024)


@pytest.mark.parametrize("kind", ["rgb", "gray", "cmyk", "png", "rgba",
                                  "palette", "png_as_jpeg"])
def test_the_cpu_reencode_is_jax_and_the_probe_reads_the_header(tmp_path,
                                                                 kind):
    """On the CPU `images.load` is PIL's re-encode (the JAX builders'); the
    card's probe reads the same width and height from the header and
    keeps only three-component JPEGs; a gray JPEG and the PNGs become
    placeholders (the PNGs already read, as PIL decodes them); CMYK is
    refused by name."""
    from PIL import Image
    path = str(tmp_path / f"x.{kind}")
    _source(path, kind, np.random.RandomState(7), (29, 47))
    with open(path, "rb") as f:
        content = f.read()
    image = Image.open(io.BytesIO(content))
    want = content
    if image.format != "JPEG" or image.mode != "RGB":
        buf = io.BytesIO()
        image.convert("RGB").save(buf, format="JPEG", quality=95)
        want = buf.getvalue()
    assert images.load(path, "cpu") == (want, 47, 29)
    if kind == "cmyk":
        with pytest.raises(images.UnsupportedImageError,
                           match=r"x\.cmyk: a 4-component \(CMYK or YCCK\)"):
            images.load(path, "cuda")
        return
    encoded, w, h = images.load(path, "cuda")
    assert (w, h) == (47, 29)
    if kind == "rgb":
        assert encoded == content
        return
    assert isinstance(encoded, images.Reencode) and encoded.path == path
    if kind == "gray":
        assert encoded.jpeg == content
    else:
        assert np.array_equal(encoded.pixels,
                              np.asarray(image.convert("RGB")))


def test_the_card_path_refuses_what_it_cannot_read(tmp_path):
    from PIL import Image
    p16 = str(tmp_path / "deep.png")
    Image.fromarray(np.arange(20 * 10, dtype=np.uint16).reshape(20, 10)
                    * 300).save(p16)
    with pytest.raises(images.UnsupportedImageError,
                       match=r"deep\.png: gray PNG at 16 bits"):
        images.load(p16, "cuda")
    text = str(tmp_path / "notes.txt")
    with open(text, "w") as f:
        f.write("hello")
    with pytest.raises(images.NotAnImageError, match="notes.txt"):
        images.load(text, "cuda")
    assert images.finish([None, {"a": records.int64_feature(1)}], "cuda") \
        [0] is None


def test_builders_refuse_the_card_without_one(tmp_path):
    """`--device` defaults to the card, as every entry point of the port:
    without one a builder raises before it reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mpii.main(["--annotations", str(tmp_path)])
