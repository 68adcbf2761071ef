"""MPII human pose → TFRecords (own copy of `Datasets/MPII/tfrecords_mpii.py`).

The train/validation JSON annotations become keypoint examples: joints
normalized by the image size, negatives kept as missing-joint markers,
visibility 0 or 2, non-JPEG and non-RGB images re-encoded (`images.py`),
64 train and 8 validation shards. Run from a directory containing
./mpii_human_pose_v1_u12_2/{train,validation}.json and ./mpii/images/:

    python -m deepvision_tpu_torch.datasets.mpii [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json

from ..data import fs, records
from . import images
from .common import add_device_flag, build_records, resolve

NUM_TRAIN_SHARDS = 64  # reference `MPII/tfrecords_mpii.py:14-15`
NUM_VAL_SHARDS = 8


def parse_one_annotation(anno: dict, image_dir: str) -> dict:
    """(`tfrecords_mpii.py:113-123`)."""
    return {
        "filename": anno["image"],
        "filepath": fs.join(image_dir, anno["image"]),
        "joints": anno["joints"],
        "joints_visibility": anno["joints_vis"],
    }


def generate_example(anno: dict, device_type: str = "cpu") -> dict:
    """(`tfrecords_mpii.py:38-84`): joints normalized by the image size in
    float64 (stored as float32), negatives kept as missing-joint markers;
    visibility 0 stays 0, anything else is 2."""
    encoded, width, height = images.load(anno["filepath"], device_type)
    xs = [j[0] / width if j[0] >= 0 else float(j[0]) for j in anno["joints"]]
    ys = [j[1] / height if j[1] >= 0 else float(j[1]) for j in anno["joints"]]
    vs = [0 if v == 0 else 2 for v in anno["joints_visibility"]]
    return {
        "image/height": records.int64_feature(height),
        "image/width": records.int64_feature(width),
        "image/depth": records.int64_feature(3),
        "image/object/parts/x": records.float_feature(xs),
        "image/object/parts/y": records.float_feature(ys),
        "image/object/parts/v": records.int64_feature(vs),
        "image/encoded": images.feature(encoded),
        "image/filename": records.bytes_feature(anno["filename"].encode()),
    }


def convert(annotations_dir: str, image_dir: str, out_dir: str,
            device: str = "cpu", num_workers: int = 0) -> int:
    example = functools.partial(generate_example,
                                device_type=device.split(":")[0])
    total = 0
    for split, json_name, shards in (
            ("train", "train.json", NUM_TRAIN_SHARDS),
            ("val", "validation.json", NUM_VAL_SHARDS)):
        with fs.open(fs.join(annotations_dir, json_name), "rb") as fp:
            annos = [parse_one_annotation(a, image_dir)
                     for a in json.load(fp)]
        print(f"{split}: {len(annos)} annotations")
        build_records(annos, shards, split, out_dir, example,
                      num_workers=num_workers, device=device)
        total += len(annos)
    print(f"Successfully wrote {total} annotations to TF Records.")
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="MPII human pose → TFRecords")
    p.add_argument("--annotations", default="./mpii_human_pose_v1_u12_2")
    p.add_argument("--images", default="./mpii/images")
    p.add_argument("--out", default="./tfrecords_mpii")
    add_device_flag(p)
    a = p.parse_args(argv)
    return convert(a.annotations, a.images, a.out, resolve(a.device))


if __name__ == "__main__":
    main()
