"""Pascal VOC → detection TFRecords, shared by VOC2007 and VOC2012 (own
copy of `Datasets/voc.py`).

Kept: the XML parse, the split from `ImageSets/Main`, class ids in
`VOC_CLASS_NAMES` order, the `[0, 1]` asserts on the normalized boxes and
`<split>_NNNN_of_MMMM.tfrecords` shard naming. The image bytes are copied
as they are (VOC's JPEGs are never re-encoded), so the device only
chooses the CRC32C the writer uses.
"""

from __future__ import annotations

from typing import Optional
from xml.etree import ElementTree as ET

from ..data import fs, records
from ..data.class_names import VOC_CLASS_NAMES
from .common import build_records


def parse_one_xml(xml_path: str, image_dir: str, names_map: dict) -> dict:
    with fs.open(xml_path, "rb") as f:
        root = ET.parse(f).getroot()
    filename = root.find(".//filename").text
    size_el = root.find("size")
    bboxes = []
    for obj in root.findall(".//object"):
        name = obj.find("name").text
        bb = obj.find("bndbox")
        diff_el = obj.find("difficult")
        bboxes.append({
            "class_text": name,
            "class_id": names_map[name],
            "difficult": int(diff_el.text) if diff_el is not None else 0,
            "xmin": int(float(bb.find("xmin").text)),
            "ymin": int(float(bb.find("ymin").text)),
            "xmax": int(float(bb.find("xmax").text)),
            "ymax": int(float(bb.find("ymax").text)),
        })
    return {
        "filepath": fs.join(image_dir, filename),
        "filename": filename,
        "width": int(size_el.find("width").text),
        "height": int(size_el.find("height").text),
        "depth": int(size_el.find("depth").text),
        "bboxes": bboxes,
    }


def generate_example(anno: dict) -> dict:
    """One image and its normalized boxes (`VOC2007/tfrecords.py:38-97`,
    the [0, 1] checks included)."""
    with fs.open(anno["filepath"], "rb") as f:
        content = f.read()
    width, height, depth = anno["width"], anno["height"], anno["depth"]
    if depth != 3:
        print(f"WARNING: image {anno['filename']} has depth {depth}")
    ids, texts, xmins, ymins, xmaxs, ymaxs, diffs = [], [], [], [], [], [], []
    for bbox in anno["bboxes"]:
        norm = [bbox["xmin"] / width, bbox["ymin"] / height,
                bbox["xmax"] / width, bbox["ymax"] / height]
        for v in norm:
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{anno['filename']}: a box outside the "
                                 f"image, normalized {norm}")
        ids.append(bbox["class_id"])
        texts.append(bbox["class_text"])
        xmins.append(norm[0])
        ymins.append(norm[1])
        xmaxs.append(norm[2])
        ymaxs.append(norm[3])
        diffs.append(bbox.get("difficult", 0))
    return {
        "image/height": records.int64_feature(height),
        "image/width": records.int64_feature(width),
        "image/depth": records.int64_feature(depth),
        "image/object/bbox/xmin": records.float_feature(xmins),
        "image/object/bbox/ymin": records.float_feature(ymins),
        "image/object/bbox/xmax": records.float_feature(xmaxs),
        "image/object/bbox/ymax": records.float_feature(ymaxs),
        "image/object/class/label": records.int64_feature(ids),
        "image/object/difficult": records.int64_feature(diffs),
        "image/object/class/text": records.bytes_feature(
            [t.encode() for t in texts]),
        "image/encoded": records.bytes_feature(content),
        "image/filename": records.bytes_feature(anno["filename"].encode()),
    }


def convert(devkit_dir: str, out_dir: str, shards_per_split: int,
            splits=("train", "val", "test"), names=None,
            device: str = "cpu", num_workers: int = 0) -> int:
    """Full conversion for one VOC year rooted at `devkit_dir`
    (e.g. ./VOCdevkit/VOC2007)."""
    names = names or VOC_CLASS_NAMES
    names_map = {n: i for i, n in enumerate(names)}
    anno_dir = fs.join(devkit_dir, "Annotations")
    image_dir = fs.join(devkit_dir, "JPEGImages")

    split_of = {}
    for split in splits:
        path = fs.join(devkit_dir, "ImageSets", "Main", f"{split}.txt")
        try:
            with fs.open(path, "rb") as fp:
                lines = fp.read().decode().splitlines()
        except FileNotFoundError:
            continue
        for line in lines:
            split_of[line.strip()] = split

    annotations = {s: [] for s in splits}
    for xml_file in sorted(fs.listdir(anno_dir)):
        image_id = xml_file[:-4]
        split = split_of.get(image_id)
        if split is None:
            print(f"WARNING: unwanted image id {image_id}")
            continue
        annotations[split].append(
            parse_one_xml(fs.join(anno_dir, xml_file), image_dir,
                          names_map))

    total = 0
    for split in splits:
        if annotations[split]:
            build_records(annotations[split], shards_per_split, split,
                          out_dir, generate_example,
                          num_workers=num_workers, device=device)
            total += len(annotations[split])
    print(f"Successfully wrote {total} annotations to TF Records.")
    return total


def main_for(year: str, shards: int, splits, argv: Optional[list] = None):
    """The command line of `Datasets/VOC<year>/tfrecords.py`, plus
    `--device`."""
    import argparse

    from .common import add_device_flag, resolve
    p = argparse.ArgumentParser(
        description=f"VOC{year} → TFRecords ({shards} shards a split)")
    p.add_argument("--devkit", default=f"./VOCdevkit/VOC{year}")
    p.add_argument("--out", default="./tfrecords_voc"
                   + ("" if year == "2007" else year))
    p.add_argument("--shards", type=int, default=shards)
    add_device_flag(p)
    a = p.parse_args(argv)
    return convert(a.devkit, a.out, a.shards, splits=splits,
                   device=resolve(a.device))
