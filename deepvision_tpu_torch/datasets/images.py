"""The image half of every dataset builder: PIL's part of
`Datasets/ILSVRC2012/build_imagenet_tfrecord.py:58-63`,
`Datasets/MPII/tfrecords_mpii.py:49-53`, `Datasets/MSCOCO/tfrecords.py:
64-68` and `CycleGAN/jax/tfrecords.py:27-31`, as the card's machine can
run it.

A builder keeps a source's bytes when they are a JPEG of three
components, and re-encodes it as a JPEG at quality 95 otherwise: PIL's
`format != "JPEG" or mode != "RGB"` (a grayscale or CMYK JPEG, a PNG).

- On the CPU (`device="cpu"`) PIL does it exactly as the JAX builders do,
  so the records equal theirs byte for byte.
- On a CUDA device nothing goes through PIL. `load` (host work only, so
  it may run in a worker process) reads the width, height and components
  from the JPEG frame header (`data/jpeg.py::extract_jpeg_shape`) or the
  PNG header, and leaves an image to re-encode as a `Reencode`
  placeholder, a PNG already read by `data/png.py`. `finish` then
  re-encodes a shard's placeholders on the card: the JPEGs decoded by
  nvJPEG in one batch (gray to three channels), the PNGs uploaded, each
  encoded by nvJPEG at quality 95, 4:2:0 (PIL's default subsampling).
  The card's JPEG differs from PIL's by a few levels (`chip_smoke.py`
  phase 18 holds it to a measured bound).
- Refused by name on the card (`UnsupportedImageError`, naming the
  file), never dropped or handed to PIL: CMYK and YCCK JPEGs (nvJPEG
  decodes neither to RGB: status 4 in a batch, 2 alone, on the H100),
  PNGs `data/png.py` does not read (16-bit, interlaced, ...), and every
  other format. Build such a set with `--device cpu`. A multi-picture
  JPEG (MPO) keeps its bytes on the card, where PIL re-encodes it.
"""

from __future__ import annotations

import io
from typing import List, NamedTuple, Optional, Tuple

from ..data import fs
from ..data.png import UnsupportedPngError, is_png, png_header, read_png

#: the re-encode of every JAX builder (PIL's save, 4:2:0 by default)
QUALITY = 95


class UnsupportedImageError(ValueError):
    """A source image the card's re-encode cannot take, named."""


class NotAnImageError(UnsupportedImageError):
    """A source that is neither a JPEG nor a PNG stream."""


class Reencode(NamedTuple):
    """A source to re-encode on the card: JPEG bytes to decode there, or
    a PNG's (H, W, 3) uint8 pixels read on the host."""
    path: str
    jpeg: Optional[bytes] = None
    pixels: Optional[object] = None


def read(path: str) -> bytes:
    with fs.open(path, "rb") as f:
        return f.read()


def probe(content: bytes, path: str) -> Tuple[str, int, int, int]:
    """(format, width, height, components) from the header alone."""
    from ..data.jpeg import extract_jpeg_shape
    if is_png(content):
        w, h, _, ctype, _ = png_header(content)
        return "PNG", w, h, ctype
    try:
        h, w, comps = extract_jpeg_shape(content)
    except ValueError as e:
        raise NotAnImageError(f"{path}: not a JPEG or PNG image ({e})"
                              ) from None
    return "JPEG", w, h, comps


def load(path: str, device_type: str, content: Optional[bytes] = None):
    """(encoded, width, height) of one source: `encoded` the bytes for the
    record, or on the card a `Reencode` placeholder that `finish`
    resolves. `content` when the caller has read the file."""
    content = read(path) if content is None else content
    if device_type == "cpu":
        return reencode_cpu(content)
    fmt, w, h, comps = probe(content, path)
    if fmt == "JPEG":
        if comps == 3:
            return content, w, h
        if comps == 1:
            return Reencode(path, jpeg=content), w, h
        raise UnsupportedImageError(
            f"{path}: a {comps}-component (CMYK or YCCK) JPEG, which the "
            f"card's decoder (nvJPEG) cannot convert to RGB; build this "
            f"dataset with --device cpu, where PIL re-encodes it")
    try:
        pixels = read_png(content)
    except UnsupportedPngError as e:
        raise UnsupportedImageError(f"{path}: {e}; or build this dataset "
                                    f"with --device cpu") from None
    return Reencode(path, pixels=pixels), w, h


def reencode_cpu(content: bytes):
    """(encoded, width, height) through PIL, as the JAX builders do."""
    from PIL import Image
    image = Image.open(io.BytesIO(content))
    if image.format != "JPEG" or image.mode != "RGB":
        with io.BytesIO() as out:
            image.convert("RGB").save(out, format="JPEG", quality=QUALITY)
            content = out.getvalue()
    width, height = image.size
    return content, width, height


def feature(encoded):
    """The `image/encoded` feature of `load`'s first value (a placeholder
    stays one until `finish`)."""
    from ..data import records
    if isinstance(encoded, Reencode):
        return encoded
    return records.bytes_feature(encoded)


def finish(examples: List[Optional[dict]], device) -> List[Optional[dict]]:
    """`examples` (feature dicts, None for a skipped item) with every
    `Reencode` value replaced by its JPEG, re-encoded on `device`."""
    pending = [(ex, key) for ex in examples if ex is not None
               for key, value in ex.items() if isinstance(value, Reencode)]
    if not pending:
        return examples
    import torch

    from ..data import jpeg
    from ..data import records
    device = torch.device(device)
    sources = [ex[key] for ex, key in pending]
    jpegs = [s.jpeg for s in sources if s.jpeg is not None]
    decoded = jpeg.decode_batch(jpegs, device) if jpegs else None
    k = 0
    for (ex, key), src in zip(pending, sources):
        if src.jpeg is not None:
            image = decoded.image(k)
            k += 1
        else:
            image = torch.from_numpy(src.pixels).to(device)
        ex[key] = records.bytes_feature(jpeg.encode_jpeg(image, QUALITY,
                                                         "420"))
    return examples
