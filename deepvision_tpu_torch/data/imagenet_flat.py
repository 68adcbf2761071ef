"""The flat-directory ImageNet loader (own copy of
deepvision_tpu/data/imagenet_flat.py, the reference's PyTorch layout): one
directory of JPEGs named `<synset>_<id>.JPEG`, labels from the synset list
(`Datasets/ILSVRC2012/synsets.txt`).

Files sorted, a rank's shard every `num_shards`-th, a per-epoch seeded
shuffle and per-image generators spawned in the JAX loader's order, so a
seed gives JAX's draws; `drop_remainder` in training; every shard capped at
the smallest shard's batch count. The decode and the transform stack
(`data/transforms.py`) run on the device: nvJPEG and one resample launch
per batch on the card, PIL and the plain resample on the CPU. Batches are
(images, labels) tensors on the device: f32 by default, uint8 at the
padded decode size under `host_decode_only` (`--device-augment`).

nvJPEG reads JPEG streams only. On the card the loader reads the first
bytes of every file of its shard when it is built and refuses a layout
that holds anything else (`NotJpegError`, naming the files): a `.png`,
or ILSVRC2012's train image n02105855_2933.JPEG, which is a PNG. Re-encode
those as JPEG, or read the layout with `--device cpu`, where PIL decodes
them as the JAX loader does.

A remote directory (gs://, memory://, ...) is listed and read through
fsspec (`data/fs.py`), and refused by name where the package of its
protocol is absent.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from . import fs
from .jpeg import (Decoded, decode_batch, decode_cpu, extract_jpeg_shape,
                   resample_batch)
from .pipeline import on_side_stream, side_stream
from .transforms import (Stack, eval_transform, host_decode_eval_transform,
                         host_decode_train_transform, train_transform)
from .util import UINT8

IMG_EXTS = (".jpeg", ".jpg", ".png")
#: a JPEG stream's start-of-image marker
JPEG_SOI = b"\xff\xd8"
#: how many of the files `NotJpegError` names
NAMED = 10


class NotJpegError(ValueError):
    """A flat layout read on the card holds files that are not JPEG."""


def not_jpeg(root_dir: str, files) -> list:
    """The names in `files` whose first bytes are not a JPEG stream's
    start-of-image marker (one 2-byte read a file, 16 at a time)."""
    def head(name):
        with fs.open(fs.join(root_dir, name), "rb") as f:
            return f.read(len(JPEG_SOI))
    with ThreadPoolExecutor(16) as pool:
        return [f for f, h in zip(files, pool.map(head, files))
                if h != JPEG_SOI]


def load_synsets(path: str) -> dict:
    """synset id → contiguous class index, in file order."""
    with fs.open(path, "rb") as fp:
        lines = fp.read().decode().splitlines()
    return {line.strip(): i for i, line in enumerate(lines) if line.strip()}


class FlatImageNet:
    """Iterable over (images, labels) batches of one flat directory;
    `batch_size` is the rank's batch."""

    def __init__(self, root_dir: str, synsets, *, batch_size: int,
                 transform: Optional[Stack] = None, training: bool = True,
                 image_size: int = 224, seed: int = 0,
                 drop_remainder: Optional[bool] = None,
                 num_shards: int = 1, shard_index: int = 0,
                 host_decode_only: bool = False, device="cpu"):
        self.root_dir = root_dir
        self.synset_to_idx = (load_synsets(synsets) if isinstance(synsets, str)
                              else dict(synsets))
        self.batch_size = batch_size
        self.training = training
        self.host_decode_only = host_decode_only
        self.device = torch.device(device)
        if transform is not None:
            self.transform = transform
        elif host_decode_only:
            self.transform = (host_decode_train_transform(image_size)
                              if training
                              else host_decode_eval_transform(image_size))
        else:
            self.transform = (train_transform(image_size) if training
                              else eval_transform(image_size))
        self.seed = seed
        self.drop_remainder = (training if drop_remainder is None
                               else drop_remainder)
        all_files = sorted(
            f for f in fs.listdir(root_dir)
            if f.lower().endswith(IMG_EXTS) and "_" in f
            and f.split("_", 1)[0] in self.synset_to_idx)
        self.files = all_files[shard_index::num_shards]
        if not self.files:
            raise FileNotFoundError(
                f"no labeled images (synset_*.JPEG) under {root_dir!r} "
                f"(shard {shard_index}/{num_shards})")
        if self.device.type == "cuda":
            bad = not_jpeg(root_dir, self.files)
            if bad:
                raise NotJpegError(
                    f"{len(bad)} file(s) under {root_dir!r} are not JPEG "
                    f"streams, which the card's decoder (nvJPEG) cannot "
                    f"read: {', '.join(bad[:NAMED])}"
                    f"{' ...' if len(bad) > NAMED else ''}. Re-encode "
                    f"them as JPEG (with PIL: Image.open(path).convert("
                    f"'RGB').save(path, 'JPEG', quality=95)), or read the "
                    f"layout with --device cpu, where PIL decodes them")
        self.epoch = 0

        # every rank runs the same number of steps: each caps its batch
        # count at the smallest shard's
        def shard_batches(n_files: int) -> int:
            return (n_files // batch_size if self.drop_remainder
                    else -(-n_files // batch_size))
        self._num_batches = min(shard_batches(len(all_files[s::num_shards]))
                                for s in range(num_shards))
        self._stream = side_stream(self.device)

    def __len__(self) -> int:
        return self._num_batches

    def _decode(self, datas) -> Decoded:
        if self.device.type == "cuda":
            return decode_batch(datas, self.device,
                                [extract_jpeg_shape(d)[:2] for d in datas])
        # PIL takes the PNGs of the layout too
        images = [torch.from_numpy(decode_cpu(d)) for d in datas]
        return Decoded([tuple(im.shape[:2]) for im in images], images=images)

    def _batch(self, names, rngs) -> Tuple[torch.Tensor, torch.Tensor]:
        datas = []
        for fname in names:
            with fs.open(fs.join(self.root_dir, fname), "rb") as f:
                datas.append(f.read())
        decoded = self._decode(datas)
        draws = [self.transform.draw(s, r)
                 for s, r in zip(decoded.shapes, rngs)]
        images = resample_batch(decoded, [d.plan for d in draws],
                                self.transform.out_size, "bilinear_aa", UINT8)
        images = self.transform.finish(images, draws)
        labels = torch.tensor([self.synset_to_idx[f.split("_", 1)[0]]
                               for f in names], dtype=torch.int32)
        return images, labels.to(self.device)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        order = np.arange(len(self.files))
        root_rng = np.random.default_rng((self.seed, self.epoch))
        if self.training:
            root_rng.shuffle(order)
        self.epoch += 1
        for n in range(self._num_batches):
            idx = order[n * self.batch_size:(n + 1) * self.batch_size]
            rngs = root_rng.spawn(len(idx))
            names = [self.files[i] for i in idx]
            yield on_side_stream(self._stream, self.device,
                                 lambda: self._batch(names, rngs))
