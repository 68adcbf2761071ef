"""MSCOCO → detection TFRecords (own copy of `Datasets/MSCOCO/tfrecords.py`).

COCO's instances JSON becomes one example an image: boxes normalized and
clipped to [0, 1] (COCO boxes can overhang the edge by a pixel),
contiguous 0-based class ids in category-id order, non-JPEG and non-RGB
images re-encoded (`images.py`), 64 train and 8 val shards. Run from a
directory containing ./annotations/instances_{train,val}2017.json and the
./{train,val}2017/ image directories:

    python -m deepvision_tpu_torch.datasets.coco [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
from collections import defaultdict

from ..data import fs, records
from . import images
from .common import add_device_flag, build_records, resolve

NUM_TRAIN_SHARDS = 64  # reference `MSCOCO/tfrecords.py:13-14`
NUM_VAL_SHARDS = 8


def load_categories(coco_json: dict) -> dict:
    """COCO category_id (1-based, sparse) → (contiguous 0-based id, name)
    (`MSCOCO/tfrecords.py:135-143` wants ids starting at 0)."""
    cats = sorted(coco_json["categories"], key=lambda c: c["id"])
    return {c["id"]: (i, c["name"]) for i, c in enumerate(cats)}


def parse_annotations(coco_json: dict, image_dir: str) -> list:
    """Instance annotations grouped by image, in the order images first
    appear among them."""
    categories = load_categories(coco_json)
    by_image = defaultdict(list)
    for anno in coco_json["annotations"]:
        class_id, class_text = categories[int(anno["category_id"])]
        x, y, w, h = anno["bbox"]  # COCO (x, y, width, height)
        by_image[anno["image_id"]].append({
            "class_id": class_id,
            "class_text": class_text,
            "xmin": float(x), "ymin": float(y),
            "xmax": float(x) + float(w), "ymax": float(y) + float(h),
        })
    return [{"filename": fs.join(image_dir,
                                 f"{str(iid).rjust(12, '0')}.jpg"),
             "bboxes": bboxes} for iid, bboxes in by_image.items()]


def generate_example(anno: dict, device_type: str = "cpu") -> dict:
    """(`MSCOCO/tfrecords.py:37-101`): the image (re-encoded where it must
    be) and its boxes normalized and clipped to [0, 1]."""
    filename = anno["filename"]
    encoded, width, height = images.load(filename, device_type)
    ids, texts, xmins, ymins, xmaxs, ymaxs = [], [], [], [], [], []
    for bbox in anno["bboxes"]:
        norm = [min(max(bbox["xmin"] / width, 0.0), 1.0),
                min(max(bbox["ymin"] / height, 0.0), 1.0),
                min(max(bbox["xmax"] / width, 0.0), 1.0),
                min(max(bbox["ymax"] / height, 0.0), 1.0)]
        ids.append(bbox["class_id"])
        texts.append(bbox["class_text"])
        xmins.append(norm[0])
        ymins.append(norm[1])
        xmaxs.append(norm[2])
        ymaxs.append(norm[3])
    return {
        "image/height": records.int64_feature(height),
        "image/width": records.int64_feature(width),
        "image/depth": records.int64_feature(3),
        "image/object/bbox/xmin": records.float_feature(xmins),
        "image/object/bbox/ymin": records.float_feature(ymins),
        "image/object/bbox/xmax": records.float_feature(xmaxs),
        "image/object/bbox/ymax": records.float_feature(ymaxs),
        "image/object/class/label": records.int64_feature(ids),
        "image/object/class/text": records.bytes_feature(
            [t.encode() for t in texts]),
        "image/encoded": images.feature(encoded),
        "image/filename": records.bytes_feature(
            fs.basename(filename).encode()),
    }


def convert(annotations_dir: str, out_dir: str, year: str = "2017",
            image_root: str = ".", device: str = "cpu",
            num_workers: int = 0) -> int:
    example = functools.partial(generate_example,
                                device_type=device.split(":")[0])
    total = 0
    for split, shards in (("train", NUM_TRAIN_SHARDS),
                          ("val", NUM_VAL_SHARDS)):
        path = fs.join(annotations_dir, f"instances_{split}{year}.json")
        with fs.open(path, "rb") as fp:
            coco_json = json.load(fp)
        annos = parse_annotations(coco_json,
                                  fs.join(image_root, f"{split}{year}"))
        build_records(annos, shards, split, out_dir, example,
                      num_workers=num_workers, device=device)
        total += len(annos)
    print(f"Successfully wrote {total} images to TF Records.")
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="MSCOCO → detection TFRecords")
    p.add_argument("--annotations", default="./annotations")
    p.add_argument("--image-root", default=".",
                   help="directory containing the train2017/ val2017 "
                        "image dirs")
    p.add_argument("--out", default="./tfrecords")
    p.add_argument("--year", default="2017")
    add_device_flag(p)
    a = p.parse_args(argv)
    return convert(a.annotations, a.out, a.year, a.image_root,
                   resolve(a.device))


if __name__ == "__main__":
    main()
