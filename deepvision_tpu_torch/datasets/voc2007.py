"""VOC2007 → TFRecords (own copy of `Datasets/VOC2007/tfrecords.py`: 2
shards a split). Run from a directory containing ./VOCdevkit/VOC2007:

    python -m deepvision_tpu_torch.datasets.voc2007 [--device cpu]
"""

from __future__ import annotations

from .voc import main_for

NUM_SHARDS = 2  # reference `VOC2007/tfrecords.py:13-15`


def main(argv=None) -> int:
    return main_for("2007", NUM_SHARDS, ("train", "val", "test"), argv)


if __name__ == "__main__":
    main()
