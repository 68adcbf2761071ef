"""VOC2012 → TFRecords (own copy of `Datasets/VOC2012/tfrecords.py`: 4
shards a split; VOC2012 has no public test annotations, so train and val
only). Run from a directory containing ./VOCdevkit/VOC2012:

    python -m deepvision_tpu_torch.datasets.voc2012 [--device cpu]
"""

from __future__ import annotations

from .voc import main_for

NUM_SHARDS = 4  # reference `VOC2012/tfrecords.py:13-15`


def main(argv=None) -> int:
    return main_for("2012", NUM_SHARDS, ("train", "val"), argv)


if __name__ == "__main__":
    main()
