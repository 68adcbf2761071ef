"""ImageNet bounding-box XML → CSV (own copy of
`Datasets/ILSVRC2012/process_bounding_boxes.py`): one line a box,
`filename,xmin,ymin,xmax,ymax`, the coordinates normalized by the image
size and clamped to [0, 1], degenerate boxes dropped, an optional synset
allow-list. The classification pipelines do not read the boxes.

    python -m deepvision_tpu_torch.datasets.imagenet_boxes <xml_dir> \\
        [synsets.txt] > boxes.csv
"""

from __future__ import annotations

import os
import sys
from xml.etree import ElementTree as ET


def process_xml(path: str) -> list:
    root = ET.parse(path).getroot()
    filename = root.find("filename").text
    size = root.find("size")
    width = float(size.find("width").text)
    height = float(size.find("height").text)
    rows = []
    for obj in root.findall("object"):
        box = obj.find("bndbox")
        xmin = min(max(float(box.find("xmin").text) / width, 0.0), 1.0)
        ymin = min(max(float(box.find("ymin").text) / height, 0.0), 1.0)
        xmax = min(max(float(box.find("xmax").text) / width, 0.0), 1.0)
        ymax = min(max(float(box.find("ymax").text) / height, 0.0), 1.0)
        if xmin >= xmax or ymin >= ymax:
            continue
        rows.append(f"{filename},{xmin:.6f},{ymin:.6f},{xmax:.6f},{ymax:.6f}")
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print(__doc__, file=sys.stderr)
        sys.exit(1)
    xml_dir = argv[0]
    allowed = None
    if len(argv) > 1:
        with open(argv[1]) as fp:
            allowed = {line.strip() for line in fp if line.strip()}
    count = 0
    for dirpath, _, files in os.walk(xml_dir):
        synset = os.path.basename(dirpath)
        if allowed is not None and synset not in allowed:
            continue
        for name in sorted(files):
            if not name.endswith(".xml"):
                continue
            for row in process_xml(os.path.join(dirpath, name)):
                print(row)
                count += 1
    print(f"wrote {count} boxes", file=sys.stderr)
    return count


if __name__ == "__main__":
    main()
