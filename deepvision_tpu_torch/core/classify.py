"""Checkpoint restore and single-image prediction for the classification
zoo (own copy of deepvision_tpu/core/classify.py: `load_class_names`,
`load_metrics`, `Classifier`), the programmatic core of what the
reference does in its per-model notebooks: load a checkpoint, plot the
saved loggers, `predict()` the top-5 of a test image.

    from deepvision_tpu_torch.core.classify import Classifier
    clf = Classifier("resnet50", workdir="runs/resnet50")
    for name, prob in clf.predict("cat.jpg"):
        print(f"{prob:6.2%}  {name}")

The checkpoint restores through the trainer's verified `Trainer.resume`,
and prediction runs on the EMA weights when the run kept them. The
preprocessing is the JAX classifier's: Rescale(256/224 of the size) →
CenterCrop → normalize for colour models, and for the MNIST-format
configs a gray image at 28 px padded to 32 (data/mnist.py). On the card a
JPEG decodes with nvJPEG and resamples in one launch of the decoder
library (data/jpeg.py), as the flat loader does (data/imagenet_flat.py);
a file that is not a JPEG, and a gray image that is not 28 x 28 (JAX
resizes it with PIL's bicubic), are refused there by name. On the CPU
PIL decodes, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.imagenet_flat import JPEG_SOI, NotJpegError
from ..data.jpeg import Decoded, decode_batch, decode_cpu, resample_batch
from ..data.transforms import eval_transform
from ..data.util import UINT8

MNIST_SIDE = 28


def load_class_names(path: Optional[str] = None,
                     num_classes: int = 1000) -> List[str]:
    """Human-readable class names. `path` may be a JSON mapping of index
    → name (the reference's `Datasets/ILSVRC2012/indices.json`, values
    like ["n01440764", "tench"]) or a text file with one name per line;
    "class <i>" placeholders when no file is given."""
    if path is None:
        return [f"class {i}" for i in range(num_classes)]
    if path.endswith(".json"):
        with open(path) as fp:
            raw = json.load(fp)
        names = [f"class {i}" for i in range(num_classes)]
        for k, v in raw.items():
            names[int(k)] = v[-1] if isinstance(v, (list, tuple)) else str(v)
        return names
    with open(path) as fp:
        return [line.strip() for line in fp if line.strip()]


def load_metrics(workdir: str) -> dict:
    """The trainer's JSONL metric logs as {metric: {"epochs": [...],
    "value": [...]}}, the shape of the reference's pickled `loggers`. A
    non-finite value, logged as a string ("nan", "inf"), comes back as
    the float it was; the run log's header line carries no number and is
    skipped."""
    out: dict = {}
    if not os.path.isdir(workdir):
        return out
    for fname in sorted(os.listdir(workdir)):
        if not fname.endswith(".jsonl"):
            continue
        with open(os.path.join(workdir, fname)) as fp:
            for line in fp:
                rec = json.loads(line)
                step = rec.get("epoch", rec.get("step", 0))
                for key, val in rec.items():
                    if isinstance(val, str):
                        try:
                            val = float(val)
                        except ValueError:
                            continue
                    if key in ("epoch", "step", "t") or not isinstance(
                            val, (int, float)):
                        continue
                    slot = out.setdefault(key, {"epochs": [], "value": []})
                    slot["epochs"].append(step)
                    slot["value"].append(val)
    return out


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 → (H, W) uint8 by PIL's `convert("L")`:
    (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    x = image.to(torch.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16).to(torch.uint8)


class Classifier:
    """Restore a trained classification checkpoint and predict top-k
    classes on `device` (the card unless "cpu")."""

    def __init__(self, model_name: str, workdir: Optional[str] = None,
                 checkpoint: Optional[int] = None,
                 image_size: Optional[int] = None,
                 class_names: Optional[Sequence[str]] = None,
                 class_names_file: Optional[str] = None, device=None):
        import dataclasses

        from ..configs import get_config
        from .trainer import Trainer

        cfg = get_config(model_name)
        self.image_size = image_size or cfg.data.image_size
        if image_size:
            cfg = cfg.replace(data=dataclasses.replace(
                cfg.data, image_size=image_size))
        self.grayscale = cfg.data.dataset == "mnist"
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.trainer = Trainer(cfg, device=device, workdir=workdir
                               or os.path.join("runs", cfg.name))
        self.device = self.trainer.device
        self.trainer.init_state()
        restored = self.trainer.resume(epoch=checkpoint)
        if restored is None:
            print("WARNING: no checkpoint found — predictions use random "
                  "weights")
        self.epoch = restored
        self.class_names = list(class_names) if class_names else \
            load_class_names(class_names_file, cfg.data.num_classes)
        self._transform = eval_transform(self.image_size)

    def close(self) -> None:
        self.trainer.close()

    def _decode(self, image) -> Decoded:
        """A path, the bytes of an image, or an (H, W[, 3]) uint8 array
        → one decoded RGB image on the device."""
        if isinstance(image, str):
            with open(image, "rb") as f:
                image = f.read()
        if isinstance(image, (bytes, bytearray)):
            data = bytes(image)
            if data.startswith(JPEG_SOI):
                # nvJPEG on the card, PIL on the CPU
                return decode_batch([data], self.device)
            if self.device.type == "cuda":
                raise NotJpegError(
                    "the card's decoder (nvJPEG) reads JPEG streams only; "
                    "re-encode the image as JPEG, or classify it with "
                    "--device cpu, where PIL decodes it")
            rgb = torch.from_numpy(decode_cpu(data))
        else:
            rgb = torch.as_tensor(np.asarray(image) if not isinstance(
                image, torch.Tensor) else image)
            if rgb.ndim == 2:
                rgb = rgb[..., None].expand(*rgb.shape, 3)
            elif rgb.shape[-1] == 1:
                rgb = rgb.expand(*rgb.shape[:2], 3)
            rgb = rgb.to(torch.uint8).to(self.device)
        return Decoded([tuple(rgb.shape[:2])], images=[rgb])

    def preprocess(self, image) -> torch.Tensor:
        """A path, image bytes or an HWC uint8 array → the normalized NHWC
        f32 batch of one on the device."""
        decoded = self._decode(image)
        if self.grayscale:
            return self._preprocess_gray(decoded.image(0))
        draw = self._transform.draw(decoded.shapes[0], None)
        images = resample_batch(decoded, [draw.plan],
                                self._transform.out_size, "bilinear_aa",
                                UINT8)
        return self._transform.finish(images, [draw])

    def _preprocess_gray(self, rgb: torch.Tensor) -> torch.Tensor:
        from ..data import mnist
        gray = rgb_to_gray(rgb)
        if tuple(gray.shape) != (MNIST_SIDE, MNIST_SIDE):
            if self.device.type == "cuda":
                raise ValueError(
                    f"a {tuple(gray.shape)} gray image: the MNIST-format "
                    f"configs take 28 x 28, and the resize to it (PIL's "
                    f"bicubic in the JAX classifier) has no card path; "
                    f"classify it with --device cpu")
            from PIL import Image
            gray = torch.from_numpy(np.array(Image.fromarray(
                gray.numpy()).resize((MNIST_SIDE, MNIST_SIDE))))
        return torch.from_numpy(mnist.preprocess(
            gray.cpu().numpy()[None])).to(self.device)

    def logits(self, image) -> torch.Tensor:
        """The main head's f32 logits (1, classes) of the eval forward on
        the EMA weights when the checkpoint carries them."""
        state = self.trainer.state
        x = self.preprocess(image)
        with state.ema_weights(), torch.inference_mode():
            state.model.eval()
            out = state.model(x.to(self.compute_dtype))
        if isinstance(out, (tuple, list)):          # inception's aux heads
            out = out[0]
        return out.float()

    def predict(self, image, top: int = 5) -> List[Tuple[str, float]]:
        """Top-k (class name, probability), like the reference notebooks'
        `predict()` (softmax → top-k over the class names)."""
        probs = torch.softmax(self.logits(image)[0], dim=-1).cpu().numpy()
        idx = np.argsort(probs)[::-1][:top]
        return [(self.class_names[i], float(probs[i])) for i in idx]
