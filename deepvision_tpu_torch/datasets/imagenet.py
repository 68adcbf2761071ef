"""ImageNet (ILSVRC2012) → TFRecords (own copy of
`Datasets/ILSVRC2012/build_imagenet_tfrecord.py`).

1024 train and 128 validation shards named `train-00000-of-01024`; the
`train_directory/<synset>/<file>.JPEG` layout, labels 1-indexed in
`synsets.txt` order (0 is background), the human-readable class text from
the metadata file, the train list shuffled by Python's
`random.Random(12345)` (numpy's generator would put other images in each
shard), PNG and CMYK oddballs re-encoded as RGB JPEGs (`images.py`: on
the card through nvJPEG, CMYK refused by name), and a pool of workers
over the shards. The schema is what `data/imagenet.py` reads:
`image/encoded` and `image/class/label` (1-based), with TF-official
metadata beside them. Run with the ILSVRC2012 files of
`Datasets/ILSVRC2012/` (or your own):

    python -m deepvision_tpu_torch.datasets.imagenet \\
        --train_directory ./train --validation_directory ./validation \\
        --labels_file ./synsets.txt [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import os
import random

from ..data import fs, records
from . import images
from .common import add_device_flag, build_records, resolve

NUM_TRAIN_SHARDS = 1024  # reference `:111-118`
NUM_VAL_SHARDS = 128
#: the seed of the train list's shuffle (`:133-135`)
SHUFFLE_SEED = 12345


def _read_lines(path: str) -> list:
    with fs.open(path, "rb") as fp:
        return fp.read().decode().splitlines()


def load_synsets(labels_file: str) -> list:
    return [line.strip() for line in _read_lines(labels_file)
            if line.strip()]


def load_human_map(metadata_file: str) -> dict:
    """`n01440764\\ttench, Tinca tinca` lines → dict (`:364-383`)."""
    out = {}
    for line in _read_lines(metadata_file):
        parts = line.strip().split("\t")
        if len(parts) == 2:
            out[parts[0]] = parts[1]
    return out


def example(item, device_type: str = "cpu") -> dict:
    """One (path, label, synset, human) item's example; width and height
    are the re-encoded image's where it was re-encoded (the same size)."""
    path, label, synset, human = item
    encoded, width, height = images.load(path, device_type)
    return {
        "image/height": records.int64_feature(height),
        "image/width": records.int64_feature(width),
        "image/colorspace": records.bytes_feature(b"RGB"),
        "image/channels": records.int64_feature(3),
        "image/class/label": records.int64_feature(label),
        "image/class/synset": records.bytes_feature(synset.encode()),
        "image/class/text": records.bytes_feature(human.encode()),
        "image/format": records.bytes_feature(b"JPEG"),
        "image/filename": records.bytes_feature(
            fs.basename(path).encode()),
        "image/encoded": images.feature(encoded),
    }


def tf_official_shard_path(out_dir: str, split: str, i: int,
                           total: int) -> str:
    """`train-00000-of-01024` naming (`:399-418`)."""
    return fs.join(out_dir,
                   f"{split}-{str(i).zfill(5)}-of-{str(total).zfill(5)}")


def build(items: list, split: str, num_shards: int, output_dir: str,
          num_workers: int, device: str = "cpu") -> list:
    return build_records(
        items, num_shards, split, output_dir,
        functools.partial(example, device_type=device.split(":")[0]),
        num_workers=num_workers, shard_path_fn=tf_official_shard_path,
        device=device)


def train_items(train_directory: str, synsets: list, label_of: dict,
                humans: dict) -> list:
    """(path, label, synset, human) of every train image, shuffled by
    `random.Random(SHUFFLE_SEED)` so the shards mix the classes."""
    items = []
    for synset in synsets:
        syn_dir = fs.join(train_directory, synset)
        if not fs.isdir(syn_dir):
            continue
        for name in sorted(fs.listdir(syn_dir)):
            items.append((fs.join(syn_dir, name), label_of[synset],
                          synset, humans.get(synset, synset)))
    random.Random(SHUFFLE_SEED).shuffle(items)
    return items


def validation_items(validation_directory: str, labels_file: str,
                     label_of: dict, humans: dict) -> list:
    """The sorted validation images with their synsets, line for line."""
    if not fs.isdir(validation_directory):
        return []
    val_synsets = [line.strip() for line in _read_lines(labels_file)
                   if line.strip()]
    val_files = sorted(fs.listdir(validation_directory))
    if len(val_files) != len(val_synsets):
        raise ValueError(f"{len(val_files)} validation images but "
                         f"{len(val_synsets)} labels in {labels_file}")
    return [(fs.join(validation_directory, name), label_of[synset], synset,
             humans.get(synset, synset))
            for name, synset in zip(val_files, val_synsets)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="ImageNet → TFRecords")
    p.add_argument("--train_directory", default="./train",
                   help="dir of <synset>/<image>.JPEG subdirs")
    p.add_argument("--validation_directory", default="./validation",
                   help="flat dir of validation images (sorted order matches "
                        "the validation labels file)")
    p.add_argument("--output_directory", default="./tfrecord")
    p.add_argument("--labels_file", default="./synsets.txt",
                   help="one synset per line; label = 1-based line index")
    p.add_argument("--imagenet_metadata_file",
                   default="./imagenet_2012_metadata.txt")
    p.add_argument("--validation_labels_file",
                   default="./imagenet_2012_validation_synset_labels.txt",
                   help="one synset per line, aligned to sorted val images")
    p.add_argument("--train_shards", type=int, default=NUM_TRAIN_SHARDS)
    p.add_argument("--validation_shards", type=int, default=NUM_VAL_SHARDS)
    p.add_argument("--num_workers", type=int, default=os.cpu_count())
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve(args.device)

    synsets = load_synsets(args.labels_file)
    label_of = {s: i + 1 for i, s in enumerate(synsets)}  # 0 = background
    humans = load_human_map(args.imagenet_metadata_file)
    train = train_items(args.train_directory, synsets, label_of, humans)
    print(f"train: {len(train)} images")
    val = validation_items(args.validation_directory,
                           args.validation_labels_file, label_of, humans)
    print(f"validation: {len(val)} images")

    build(train, "train", args.train_shards, args.output_directory,
          args.num_workers, device)
    if val:
        build(val, "validation", args.validation_shards,
              args.output_directory, args.num_workers, device)
    print("done")


if __name__ == "__main__":
    main()
