"""CycleGAN two-domain image directories → one TFRecord a split (own copy
of `CycleGAN/jax/tfrecords.py`): `{trainA,trainB,testA,testB}.tfrecord`
from `<data-root>/<dataset>/<split>/*`, sorted, non-JPEG and non-RGB
images re-encoded (`images.py`), a file that is not an image skipped with
a warning (`:47-49`). On the card a CMYK JPEG or a PNG the reader does
not take is refused by name, not skipped: it is an image the card cannot
re-encode, which `--device cpu` builds.

    python -m deepvision_tpu_torch.datasets.cyclegan --dataset monet2photo
"""

from __future__ import annotations

import argparse
import io

from ..data import fs, records
from . import images
from .common import add_device_flag, resolve, write_examples

SPLITS = ("trainA", "trainB", "testA", "testB")


def example(img_path: str, device_type: str = "cpu"):
    """The example of one image, or None (with a warning) for a file that
    is not one."""
    try:
        content = images.read(img_path)
        if device_type == "cpu":
            from PIL import Image
            with Image.open(io.BytesIO(content)) as im:
                im.load()
                if im.format != "JPEG" or im.mode != "RGB":
                    with io.BytesIO() as out:
                        im.convert("RGB").save(out, format="JPEG",
                                               quality=images.QUALITY)
                        content = out.getvalue()
                encoded, width, height = content, im.width, im.height
        else:
            encoded, width, height = images.load(img_path, device_type,
                                                 content)
    except images.UnsupportedImageError as e:
        if not isinstance(e, images.NotAnImageError):
            raise
        print(f"WARNING: skipping {img_path}: {e}")
        return None
    except Exception as e:  # noqa: BLE001 — a bad image skipped (`:47-49`)
        if device_type != "cpu" and not isinstance(e, OSError):
            raise
        print(f"WARNING: skipping {img_path}: {e}")
        return None
    return {
        "image/encoded": images.feature(encoded),
        "image/format": records.bytes_feature(b"JPEG"),
        "image/width": records.int64_feature(width),
        "image/height": records.int64_feature(height),
        "image/filename": records.bytes_feature(
            fs.basename(img_path).encode()),
    }


def convert(dataset: str, data_root: str, out_root: str,
            device: str = "cpu") -> dict:
    """Every split present; {split: images written}."""
    device_type = device.split(":")[0]
    out_dir = fs.join(out_root, dataset)
    fs.makedirs(out_dir)
    written = {}
    for split in SPLITS:
        files = fs.glob(fs.join(data_root, dataset, split, "*"))
        if not files:
            continue
        examples = [example(path, device_type) for path in files]
        n = write_examples(fs.join(out_dir, f"{split}.tfrecord"), examples,
                           device)
        written[split] = n
        print(f"Finished converting {n} images for {split}")
    return written


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="Convert TFRecords for a CycleGAN dataset.")
    p.add_argument("--dataset", required=True,
                   help="name under ./datasets/ with trainA/trainB"
                        "[/testA/testB]")
    p.add_argument("--data-root", default="./datasets")
    p.add_argument("--out-root", default="./tfrecords")
    add_device_flag(p)
    args = p.parse_args(argv)
    return convert(args.dataset, args.data_root, args.out_root,
                   resolve(args.device))


if __name__ == "__main__":
    main()
