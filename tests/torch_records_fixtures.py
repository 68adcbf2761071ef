"""Small on-disk datasets for the port's loader tests, written by
TensorFlow and the JAX package's own converters (`Datasets/voc.py`,
`Datasets/MPII/tfrecords_mpii.py`, `CycleGAN/jax/tfrecords.py`): ImageNet
TFRecord shards, VOC-format detection records, MPII pose records,
CycleGAN's two-domain records and a flat ImageNet directory, from seeded
images with edges and flat areas."""

import importlib
import io
import os
import struct
import sys
import zlib

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def natural_image(h: int, w: int, rs: np.random.RandomState,
                  gray: bool = False) -> np.ndarray:
    """Smooth gradients, a disc and noise, (h, w, 3) or (h, w) uint8."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rs.uniform(0, 6)
    chans = []
    for c in range(1 if gray else 3):
        base = 128 + 90 * np.sin(x / (5 + 3 * c) + c + phase) \
            * np.cos(y / (7 + c))
        disc = (y - h / 2) ** 2 + (x - w / 3) ** 2 < (min(h, w) / 4) ** 2
        chans.append(base + 60 * disc * (1 - 2 * (c % 2))
                     + rs.normal(0, 12, (h, w)))
    img = np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def jpeg(image: np.ndarray, quality: int = 90, subsampling: int = 2,
         **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    opts = dict(quality=quality, **kw)
    if image.ndim == 3:
        opts["subsampling"] = subsampling
    Image.fromarray(image).save(buf, "JPEG", **opts)
    return buf.getvalue()


def png(image: np.ndarray) -> bytes:
    """An (h, w, 3) uint8 image as a PNG file, written with zlib alone
    (no PIL: the card's host has none)."""
    h, w, _ = image.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    rows = b"".join(b"\x00" + image[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _example(features: dict) -> bytes:
    import tensorflow as tf
    feats = {}
    for k, v in features.items():
        if isinstance(v, bytes):
            feats[k] = tf.train.Feature(bytes_list=tf.train.BytesList(
                value=[v]))
        elif isinstance(v, int):
            feats[k] = tf.train.Feature(int64_list=tf.train.Int64List(
                value=[v]))
        else:
            raise TypeError(k)
    return tf.train.Example(features=tf.train.Features(
        feature=feats)).SerializeToString()


def write_imagenet(root: str, split: str, shards, seed: int = 0,
                   size_range=(30, 70), gray_every: int = 0,
                   num_classes: int = 1000) -> list:
    """`<split>-0000i-of-0000n` TFRecord shards of the TF-official schema;
    `shards` is the record count of each shard. Record n's label is
    n % num_classes (1-indexed on disk), n counting in write order.
    Returns the (encoded, label) pairs in write order."""
    import tensorflow as tf
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(seed)
    out, n = [], 0
    for s, count in enumerate(shards):
        path = os.path.join(root, f"{split}-{s:05d}-of-{len(shards):05d}")
        with tf.io.TFRecordWriter(path) as w:
            for _ in range(count):
                h, wd = rs.randint(*size_range, size=2)
                gray = bool(gray_every) and n % gray_every == gray_every - 1
                data = jpeg(natural_image(h, wd, rs, gray))
                label = n % num_classes
                w.write(_example({"image/encoded": data,
                                  "image/class/label": label + 1}))
                out.append((data, label))
                n += 1
    return out


VOC_XML = """<annotation>
  <filename>{name}.jpg</filename>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
{objects}</annotation>"""
VOC_OBJECT = """  <object><name>{cls}</name><difficult>{diff}</difficult>
    <bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox>
  </object>
"""


def write_voc(root: str, splits=(("train", 6), ("val", 5)), seed: int = 0
              ) -> str:
    """A VOC devkit of seeded scenes with 1-3 boxes each (some difficult),
    converted by `Datasets/voc.py`, one shard a split. Returns the
    records' directory."""
    sys.path.insert(0, REPO)
    from Datasets.voc import convert
    rs = np.random.RandomState(seed)
    devkit = os.path.join(root, "VOCdevkit", "VOC2007")
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(devkit, sub), exist_ok=True)
    classes = ["dog", "person", "car", "cat"]
    k = 0
    for split, count in splits:
        ids = []
        for _ in range(count):
            name = f"{k:06d}"
            k += 1
            h, w = rs.randint(40, 90, size=2)
            with open(os.path.join(devkit, "JPEGImages", f"{name}.jpg"),
                      "wb") as f:
                f.write(jpeg(natural_image(h, w, rs)))
            objs = ""
            for _ in range(rs.randint(1, 4)):
                x0, y0 = rs.randint(0, w // 2), rs.randint(0, h // 2)
                x1, y1 = rs.randint(x0 + 4, w), rs.randint(y0 + 4, h)
                objs += VOC_OBJECT.format(cls=classes[rs.randint(4)],
                                          diff=int(rs.rand() < 0.2), x0=x0,
                                          y0=y0, x1=x1, y1=y1)
            with open(os.path.join(devkit, "Annotations", f"{name}.xml"),
                      "w") as f:
                f.write(VOC_XML.format(name=name, w=w, h=h, objects=objs))
            ids.append(name)
        with open(os.path.join(devkit, "ImageSets", "Main", f"{split}.txt"),
                  "w") as f:
            f.write("\n".join(ids) + "\n")
    out = os.path.join(root, "tfrecords")
    convert(devkit, out, shards_per_split=1,
            splits=tuple(s for s, _ in splits))
    return out


def write_mpii(root: str, splits=(("train", 5), ("val", 5)), seed: int = 0
               ) -> str:
    """MPII-format records by `Datasets/MPII/tfrecords_mpii.py`: 16 joints
    per person, some missing (-1), one record with every joint missing."""
    import tensorflow as tf
    sys.path.insert(0, os.path.join(REPO, "Datasets", "MPII"))
    mpii = importlib.import_module("tfrecords_mpii")
    rs = np.random.RandomState(seed)
    images = os.path.join(root, "images")
    os.makedirs(images, exist_ok=True)
    out = os.path.join(root, "tfrecords_mpii")
    os.makedirs(out, exist_ok=True)
    k = 0
    for split, count in splits:
        path = os.path.join(out, f"{split}_0001_of_0001.tfrecords")
        with tf.io.TFRecordWriter(path) as w:
            for i in range(count):
                h, wd = rs.randint(40, 90, size=2)
                name = f"{k}.jpg"
                k += 1
                with open(os.path.join(images, name), "wb") as f:
                    f.write(jpeg(natural_image(h, wd, rs)))
                joints, vis = [], []
                for j in range(16):
                    missing = i == 0 or rs.rand() < 0.2
                    joints.append([-1, -1] if missing else
                                  [int(rs.randint(5, wd - 5)),
                                   int(rs.randint(5, h - 5))])
                    vis.append(0 if missing else 1)
                anno = mpii.parse_one_annotation(
                    {"image": name, "joints": joints, "joints_vis": vis},
                    images)
                w.write(mpii.generate_tfexample(anno).SerializeToString())
    return out


def write_cyclegan(root: str, counts=(5, 4), seed: int = 0) -> str:
    """`<root>/toy/{trainA,trainB}.tfrecord`, each image converted by
    `CycleGAN/jax/tfrecords.py::convert_to_tfexample`. Returns the root."""
    import tensorflow as tf
    sys.path.insert(0, os.path.join(REPO, "CycleGAN", "jax"))
    conv = importlib.import_module("tfrecords")
    rs = np.random.RandomState(seed)
    d = os.path.join(root, "toy")
    os.makedirs(d, exist_ok=True)
    for dom, count in zip("AB", counts):
        with tf.io.TFRecordWriter(os.path.join(d, f"train{dom}.tfrecord")) \
                as w:
            for i in range(count):
                h, wd = rs.randint(30, 60, size=2)
                src = os.path.join(d, f"{dom}{i}.jpg")
                with open(src, "wb") as f:
                    f.write(jpeg(natural_image(h, wd, rs)))
                w.write(conv.convert_to_tfexample(src).SerializeToString())
    return root


def write_flat(root: str, n: int = 10, seed: int = 0) -> dict:
    """A flat directory of `<synset>_<i>.JPEG` over two synsets; returns
    the synset map."""
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(seed)
    for i in range(n):
        h, w = rs.randint(40, 90, size=2)
        with open(os.path.join(root, f"n0{1 + i % 2}_{i}.JPEG"), "wb") as f:
            f.write(jpeg(natural_image(h, w, rs)))
    return {"n01": 0, "n02": 1}
