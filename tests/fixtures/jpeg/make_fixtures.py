"""Writes the JPEG decode fixtures of this directory and their goldens.

    python tests/fixtures/jpeg/make_fixtures.py

Each `<name>.jpg` is a small seeded image encoded by PIL; `<name>.pil.npy`
is PIL's decode of it (`convert("RGB")`, equal to TensorFlow's
`decode_jpeg(..., dct_method="INTEGER_ACCURATE")`), `<name>.tf.npy`
TensorFlow's default decode (the JAX pipelines' decode). The card's
decoder is held to both where neither PIL nor TensorFlow is installed
(`chip_smoke.py` phase 18a, `tests/test_torch_cuda.py`).
"""

import io
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# name -> (height, width, gray, PIL save options)
FIXTURES = {
    "q90_444": (47, 61, False, dict(quality=90, subsampling=0)),
    "q90_420": (48, 64, False, dict(quality=90, subsampling=2)),
    "q85_422_odd": (53, 37, False, dict(quality=85, subsampling=1)),
    "gray": (33, 40, True, dict(quality=90)),
    "progressive_420": (64, 64, False, dict(quality=90, subsampling=2,
                                            progressive=True)),
    "restart_420": (48, 80, False, dict(quality=90, subsampling=2,
                                        restart_marker_blocks=2)),
}


def image(h: int, w: int, gray: bool, seed: int) -> np.ndarray:
    """Smooth gradients, a disc and noise: edges and flat areas both."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = []
    for c in range(1 if gray else 3):
        base = 128 + 90 * np.sin(x / (5 + 3 * c) + c) * np.cos(y / (7 + c))
        disc = ((y - h / 2) ** 2 + (x - w / 3) ** 2 < (min(h, w) / 4) ** 2)
        chans.append(base + 60 * disc * (1 - 2 * (c % 2))
                     + rs.normal(0, 12, (h, w)))
    img = np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def main() -> None:
    import tensorflow as tf
    from PIL import Image
    for seed, (name, (h, w, gray, opts)) in enumerate(FIXTURES.items()):
        buf = io.BytesIO()
        Image.fromarray(image(h, w, gray, seed)).save(buf, "JPEG", **opts)
        data = buf.getvalue()
        with open(os.path.join(HERE, f"{name}.jpg"), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            pil = np.asarray(im.convert("RGB"))
        acc = tf.io.decode_jpeg(data, channels=3,
                                dct_method="INTEGER_ACCURATE").numpy()
        if not np.array_equal(pil, acc):
            raise AssertionError(f"{name}: PIL and INTEGER_ACCURATE differ")
        np.save(os.path.join(HERE, f"{name}.pil.npy"), pil)
        np.save(os.path.join(HERE, f"{name}.tf.npy"),
                tf.io.decode_jpeg(data, channels=3).numpy())
        print(name, len(data), "bytes", pil.shape)


if __name__ == "__main__":
    main()
