"""Shared dataset-builder infrastructure (own copy of `Datasets/common.py`):
chunked shard lists, shard naming and the parallel shard writer, writing
through the port's `data/records.py` (`encode_example`,
`write_records`) instead of TensorFlow.

Workers. As in JAX, shards fan out to a process pool, but a `spawn` one:
a forked child cannot use a CUDA context its parent made, and forking a
process that holds threads (torch's, a CUDA context's) is unsafe. What
runs in the pool is host work only: reading the sources, parsing the
annotations, probing the image headers (and, on the CPU, PIL's
re-encode). On the CPU each worker writes its own shards, as JAX's do. On
the card the workers return their shards' examples, and the parent
re-encodes the images that need it on the card (`images.finish`) and
writes the shards, with the CRC32C of the decoder library; so only the
parent holds a CUDA context. Results are taken in shard order with at
most two shards a worker in flight.

Outputs may be remote (`data/fs.py`): a URL goes through fsspec.
Workers write a CPU build's shards in their own processes, so an
in-memory file system (`memory://`) needs `num_workers=1`.
"""

from __future__ import annotations

import collections
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, List, Optional, Sequence

from ..data import fs, records
from . import images


def add_device_flag(parser) -> None:
    """`--device`, which every builder takes besides the JAX script's
    flags."""
    parser.add_argument("--device", default="cuda",
                        help="where images are re-encoded: cuda (default; "
                             "nvJPEG, raises without a card) or cpu (PIL, "
                             "byte for byte the JAX builders' output)")


def resolve(device: str) -> str:
    """The device a builder runs on (raises for `cuda` without a
    card, as every entry point of the port)."""
    from ..utils.device import resolve_device
    return str(resolve_device(device))


def chunkify(items: Sequence, n: int) -> List[list]:
    """Split into n near-equal chunks (`VOC2007/tfrecords.py:20-35`)."""
    size = len(items) // n
    chunks = []
    for i in range(n - 1):
        chunks.append(list(items[i * size:(i + 1) * size]))
    chunks.append(list(items[(n - 1) * size:]))
    return chunks


def shard_path(out_dir: str, split: str, index: int, total: int) -> str:
    """`train_0001_of_0064.tfrecords` naming
    (`VOC2007/tfrecords.py:113-120`)."""
    return fs.join(
        out_dir, f"{split}_{str(index + 1).zfill(4)}_of_{str(total).zfill(4)}"
                 ".tfrecords")


def shard_examples(chunk: list, example_fn: Callable) -> List[Optional[dict]]:
    """One shard's examples; `example_fn(item) -> features dict or None`."""
    return [example_fn(item) for item in chunk]


def write_shard(chunk: list, path: str, example_fn: Callable,
                device: str = "cpu") -> str:
    """Build and write one shard (the card's re-encodes made first)."""
    write_examples(path, shard_examples(chunk, example_fn), device)
    return path


def write_examples(path: str, examples: List[Optional[dict]],
                   device: str) -> int:
    examples = images.finish(examples, device)
    crc = records.crc32c_py
    if device != "cpu":
        from ..data.jpeg import host_crc32c
        crc = host_crc32c(device)
    return records.write_records(
        path, (records.encode_example(ex) for ex in examples
               if ex is not None), crc=crc)


def build_records(annotations: Sequence, total_shards: int, split: str,
                  out_dir: str, example_fn: Callable,
                  num_workers: int = 0,
                  shard_path_fn: Optional[Callable] = None,
                  device: str = "cpu") -> List[str]:
    """Parallel shard writer, `build_tfrecords`'s counterpart: chunks of
    `annotations` in order, one shard each, `example_fn` picklable (a
    module-level function or a partial of one). `shard_path_fn`
    overrides the naming (the ILSVRC builder's `train-00000-of-01024`);
    `device` is where images are re-encoded."""
    fs.makedirs(out_dir)
    chunks = chunkify(annotations, total_shards)
    shard_path_fn = shard_path_fn or shard_path
    paths = [shard_path_fn(out_dir, split, i, total_shards)
             for i in range(total_shards)]
    num_workers = num_workers or min(total_shards, os.cpu_count() or 1)
    if num_workers <= 1 or total_shards == 1:
        return [write_shard(c, p, example_fn, device)
                for c, p in zip(chunks, paths)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=num_workers, mp_context=ctx) as pool:
        if device == "cpu":
            futures = [pool.submit(write_shard, c, p, example_fn)
                       for c, p in zip(chunks, paths)]
            return [f.result() for f in futures]
        window: collections.deque = collections.deque()
        todo = iter(zip(chunks, paths))
        for chunk, path in todo:
            window.append((pool.submit(shard_examples, chunk, example_fn),
                           path))
            if len(window) >= 2 * num_workers:
                break
        while window:
            future, path = window.popleft()
            write_examples(path, future.result(), device)
            nxt = next(todo, None)
            if nxt is not None:
                window.append((pool.submit(shard_examples, nxt[0],
                                           example_fn), nxt[1]))
    return paths
