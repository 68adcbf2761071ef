"""Writes the re-encode fixtures of this directory: sources a dataset
builder re-encodes (not a three-component JPEG) and PIL's re-encodes of
them, the JAX builders' output.

    python tests/fixtures/reencode/make_fixtures.py

`<name>.<ext>` is a small seeded source: a grayscale and a CMYK JPEG,
and 8-bit gray, RGB, RGBA and palette PNGs. `<name>.rgb.npy` is PIL's
`convert("RGB")` of it; `<name>.pil95.jpg` is `convert("RGB")` saved as
a JPEG at quality 95, as every JAX builder re-encodes. The card's
re-encode (nvJPEG, `deepvision_tpu_torch/datasets/images.py`) is held to
them where PIL is not installed (`chip_smoke.py` phase 18,
`tests/test_torch_cuda.py`).
"""

import io
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 97, 131
# name -> (file extension, PIL mode, save options)
FIXTURES = {
    "gray": ("jpg", "L", dict(format="JPEG", quality=90)),
    "cmyk": ("jpg", "CMYK", dict(format="JPEG", quality=90)),
    "gray_png": ("png", "L", dict(format="PNG")),
    "rgb_png": ("png", "RGB", dict(format="PNG")),
    "rgba_png": ("png", "RGBA", dict(format="PNG")),
    "palette_png": ("png", "P", dict(format="PNG")),
}


def image(seed: int) -> np.ndarray:
    """(H, W, 4) uint8: gradients, a disc and noise in every channel."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    chans = []
    for c in range(4):
        base = 128 + 90 * np.sin(x / (5 + 3 * c) + c) * np.cos(y / (7 + c))
        disc = ((y - H / 2) ** 2 + (x - W / 3) ** 2 < (min(H, W) / 4) ** 2)
        chans.append(base + 60 * disc * (1 - 2 * (c % 2))
                     + rs.normal(0, 12, (H, W)))
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


def source(name: str, seed: int) -> bytes:
    from PIL import Image
    ext, mode, opts = FIXTURES[name]
    pixels = image(seed)
    if mode == "L":
        im = Image.fromarray(pixels[..., 0], "L")
    elif mode == "P":
        im = Image.fromarray(pixels[..., :3], "RGB").quantize(200)
    else:
        im = Image.fromarray(pixels[..., :len(mode)], mode)
    buf = io.BytesIO()
    im.save(buf, **opts)
    return buf.getvalue()


def main() -> None:
    from PIL import Image
    for seed, name in enumerate(FIXTURES):
        ext = FIXTURES[name][0]
        data = source(name, seed)
        with open(os.path.join(HERE, f"{name}.{ext}"), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            rgb = im.convert("RGB")
            np.save(os.path.join(HERE, f"{name}.rgb.npy"), np.asarray(rgb))
            buf = io.BytesIO()
            rgb.save(buf, format="JPEG", quality=95)
        with open(os.path.join(HERE, f"{name}.pil95.jpg"), "wb") as f:
            f.write(buf.getvalue())
        print(name, len(data), "bytes, re-encoded", len(buf.getvalue()))


if __name__ == "__main__":
    main()
