"""A reader of TensorFlow's V2 checkpoints (the tensor bundle that
`tf.train.Checkpoint.save` and `tf.raw_ops.SaveV2` write), without
TensorFlow: the port's counterpart of `tf.train.load_checkpoint` and
`tf.train.latest_checkpoint`.

A checkpoint `<prefix>` is two kinds of file:
- `<prefix>.index`, a LevelDB-format table. Its 48-byte footer holds the
  meta-index and index block handles and the magic 0xdb4775248b80fb57;
  the index block's values are the handles of the data blocks. A block is
  entries (shared key bytes, unshared key bytes and value length as
  varints, the key's new bytes, the value) and the restart array (fixed32
  offsets, then their count); its 5-byte trailer is a compression type
  (0, none: snappy is refused by name) and the masked CRC32C of the block
  and the type, which is checked. The key "" holds the
  `BundleHeaderProto` (shard count, endianness: big-endian is refused);
  every other key is a tensor's name and holds its `BundleEntryProto`
  (dtype, shape, shard, offset, size, masked CRC32C; a partitioned
  variable's slices are refused by name when it is read). Both protos
  are parsed here from their wire format, as `data/records.py` parses
  `tf.train.Example`.
- `<prefix>.data-<k>-of-<n>`, the shards, which hold each tensor's bytes
  at its entry's offset; each tensor's CRC32C is checked when it is read.

dtypes: DT_FLOAT, DT_DOUBLE, DT_HALF, DT_INT32, DT_INT64 and DT_BOOL.
DT_STRING tensors (the object graph, `_CHECKPOINTABLE_OBJECT_GRAPH`) are
listed with their shape but not decoded.

CRC32C is computed by `crc` (a callable `crc(bytes) -> int`), as in
`data/records.py`: by default `crc32c_np` here (numpy lanes, for the
large tensors that make `data/records.py::crc32c_py`'s byte loop slow),
the decoder library's SSE4.2 function on the card
(`data/jpeg.py::host_crc32c`).
"""

from __future__ import annotations

import ast
import os
import re
import struct
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, \
    Tuple

import numpy as np

from ..data.records import _TABLE, crc32c_py, masked_crc

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_SIZE = 48
OBJECT_GRAPH = "_CHECKPOINTABLE_OBJECT_GRAPH"

# DataType enum (tensorflow/core/framework/types.proto)
DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"),
          9: np.dtype("<i8"), 10: np.dtype("bool"), 19: np.dtype("<f2")}
DTYPE_NAMES = {1: "DT_FLOAT", 2: "DT_DOUBLE", 3: "DT_INT32", 4: "DT_UINT8",
               5: "DT_INT16", 6: "DT_INT8", 7: "DT_STRING",
               8: "DT_COMPLEX64", 9: "DT_INT64", 10: "DT_BOOL",
               14: "DT_BFLOAT16", 17: "DT_UINT16", 18: "DT_COMPLEX128",
               19: "DT_HALF", 20: "DT_RESOURCE", 21: "DT_VARIANT",
               22: "DT_UINT32", 23: "DT_UINT64"}


class CheckpointFormatError(ValueError):
    """A table or tensor whose bytes or CRC do not check out."""


# -- CRC32C in numpy lanes ----------------------------------------------------
#
# A CRC without its initial and final inversion is linear over GF(2):
# raw(A + B) = shift(raw(A), len(B)) ^ raw(B), where shift runs the state
# through zero bytes, and leading zero bytes leave a zero state at zero.
# So the data, padded with zeros in front, is cut into _LANES equal lanes
# whose raw CRCs numpy runs side by side, then folded pairwise, each left
# lane shifted past its right neighbour.

_LANES = 65536
_TABLE_NP = np.array(_TABLE, np.uint32)


def _shifted(op: List[int], v: int) -> int:
    """`v` through the linear map whose bit images are `op`."""
    out, i = 0, 0
    while v:
        if v & 1:
            out ^= op[i]
        v >>= 1
        i += 1
    return out


def _zero_bytes(n: int) -> List[int]:
    """The bit images of a raw CRC state run through `n` zero bytes."""
    result = [1 << i for i in range(32)]
    base = [_TABLE[(1 << i) & 0xFF] ^ ((1 << i) >> 8) for i in range(32)]
    while n:
        if n & 1:
            result = [_shifted(base, v) for v in result]
        base = [_shifted(base, v) for v in base]
        n >>= 1
    return result


def crc32c_np(data: bytes, crc: int = 0) -> int:
    """CRC32C of `data`, equal to `crc32c_py(data, crc)`; data shorter
    than 16 lanes goes to `crc32c_py`."""
    n = len(data)
    if n < 16 * _LANES:
        return crc32c_py(data, crc)
    width = -(-n // _LANES)
    padded = np.zeros(_LANES * width, np.uint8)
    padded[len(padded) - n:] = np.frombuffer(data, np.uint8)
    state = np.zeros(_LANES, np.uint32)
    for column in np.ascontiguousarray(padded.reshape(_LANES, width).T):
        state = _TABLE_NP[(state ^ column) & 0xFF] ^ (state >> np.uint32(8))
    while len(state) > 1:
        op = _zero_bytes(width)
        right = state[1::2]
        for i, image in enumerate(op):
            right = right ^ (((state[0::2] >> np.uint32(i)) & np.uint32(1))
                             * np.uint32(image))
        state, width = right, 2 * width
    return (_shifted(_zero_bytes(n), crc ^ 0xFFFFFFFF) ^ int(state[0])
            ^ 0xFFFFFFFF)


# -- protobuf wire format -----------------------------------------------------

def _varint(buf: bytes, at: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if at >= len(buf):
            raise CheckpointFormatError("truncated varint")
        b = buf[at]
        value |= (b & 0x7F) << shift
        at += 1
        if not b & 0x80:
            return value, at
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a serialized message: an int
    for varint and fixed fields, bytes for length-delimited ones."""
    at = 0
    while at < len(buf):
        tag, at = _varint(buf, at)
        number, wire = tag >> 3, tag & 7
        if wire == 0:
            value, at = _varint(buf, at)
        elif wire == 1:
            value, at = struct.unpack_from("<Q", buf, at)[0], at + 8
        elif wire == 2:
            n, at = _varint(buf, at)
            value, at = buf[at:at + n], at + n
        elif wire == 5:
            value, at = struct.unpack_from("<I", buf, at)[0], at + 4
        else:
            raise CheckpointFormatError(f"wire type {wire} in a proto")
        yield number, wire, value


class Entry(NamedTuple):
    """A `BundleEntryProto`."""
    dtype: int
    shape: Tuple[int, ...]
    shard_id: int
    offset: int
    size: int
    crc32c: int
    slices: int                 # count of TensorSliceProto


def parse_entry(buf: bytes) -> Entry:
    dtype = shard = offset = size = crc = slices = 0
    shape: List[int] = []
    for number, _, value in _fields(buf):
        if number == 1:
            dtype = value
        elif number == 2:                       # TensorShapeProto
            for n, _, dim in _fields(value):
                if n == 2:
                    size_of = [v for k, _, v in _fields(dim) if k == 1]
                    # a negative (unknown) size comes as 2^64 - 1
                    d = size_of[0] if size_of else 0
                    shape.append(d - (1 << 64) if d >= 1 << 63 else d)
                elif n == 3 and dim:
                    raise CheckpointFormatError("tensor of unknown rank")
        elif number == 3:
            shard = value
        elif number == 4:
            offset = value
        elif number == 5:
            size = value
        elif number == 6:
            crc = value
        elif number == 7:
            slices += 1
    return Entry(dtype, tuple(shape), shard, offset, size, crc, slices)


# -- the LevelDB table --------------------------------------------------------

def _block_handle(buf: bytes, at: int) -> Tuple[int, int, int]:
    offset, at = _varint(buf, at)
    size, at = _varint(buf, at)
    return offset, size, at


def _block_entries(block: bytes, where: str) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) of a block in order, keys rebuilt from their shared
    prefixes; each restart point must start an entry with no shared
    prefix."""
    if len(block) < 4:
        raise CheckpointFormatError(f"{where}: block of {len(block)} bytes")
    (restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    end = len(block) - 4 - 4 * restarts
    if end < 0:
        raise CheckpointFormatError(f"{where}: {restarts} restarts do not "
                                    f"fit a block of {len(block)} bytes")
    points = set(struct.unpack_from(f"<{restarts}I", block, end))
    key, at = b"", 0
    while at < end:
        start = at
        shared, at = _varint(block, at)
        unshared, at = _varint(block, at)
        length, at = _varint(block, at)
        if start in points and shared:
            raise CheckpointFormatError(f"{where}: restart point {start} "
                                        f"shares {shared} key bytes")
        if shared > len(key) or at + unshared + length > end:
            raise CheckpointFormatError(f"{where}: entry at {start} "
                                        f"overruns its block")
        key = key[:shared] + block[at:at + unshared]
        at += unshared
        yield key, block[at:at + length]
        at += length


class _Table:
    """The key-value entries of an SSTable file, every block's CRC
    checked."""

    def __init__(self, path: str, crc: Callable[[bytes], int]):
        self.path, self.crc = path, crc
        with open(path, "rb") as fp:
            self.data = fp.read()
        if len(self.data) < FOOTER_SIZE:
            raise CheckpointFormatError(f"{path}: {len(self.data)} bytes, "
                                        f"shorter than a table footer")
        footer = self.data[-FOOTER_SIZE:]
        (magic,) = struct.unpack_from("<Q", footer, FOOTER_SIZE - 8)
        if magic != TABLE_MAGIC:
            raise CheckpointFormatError(f"{path}: table magic {magic:#x}, "
                                        f"not {TABLE_MAGIC:#x}")
        _, _, at = _block_handle(footer, 0)        # the meta-index
        self.index = _block_handle(footer, at)[:2]

    def block(self, offset: int, size: int, what: str) -> bytes:
        where = f"{self.path}: {what} block at {offset}"
        if offset + size + 5 > len(self.data):
            raise CheckpointFormatError(f"{where} runs past the end")
        body = self.data[offset:offset + size]
        kind = self.data[offset + size]
        (stored,) = struct.unpack_from("<I", self.data, offset + size + 1)
        if masked_crc(self.crc(body + bytes([kind]))) != stored:
            raise CheckpointFormatError(f"{where}: bad block CRC32C")
        if kind == 1:
            raise NotImplementedError(f"{where}: snappy-compressed block; "
                                      f"this reader knows uncompressed "
                                      f"tables, as tensor bundles write")
        if kind != 0:
            raise CheckpointFormatError(f"{where}: compression type {kind}")
        return body

    def entries(self) -> Iterator[Tuple[bytes, bytes]]:
        index = self.block(*self.index, "index")
        for _, handle in _block_entries(index, f"{self.path}: index"):
            offset, size, _ = _block_handle(handle, 0)
            yield from _block_entries(self.block(offset, size, "data"),
                                      f"{self.path}: data block at "
                                      f"{offset}")


# -- the bundle ---------------------------------------------------------------

class CheckpointReader:
    """`tf.train.load_checkpoint(prefix)`'s reader: the variables' shapes,
    `has_tensor` and `get_tensor` (a numpy array, its CRC32C checked)."""

    def __init__(self, prefix: str,
                 crc: Callable[[bytes], int] = crc32c_np):
        self.prefix, self.crc = prefix, crc
        index = prefix + ".index"
        if not os.path.exists(index):
            raise FileNotFoundError(f"no checkpoint index {index}")
        self.entries: Dict[str, Entry] = {}
        header = None
        for key, value in _Table(index, crc).entries():
            if key == b"":
                header = value
                continue
            if key[:1] == b"\0":
                continue            # a slice of a partitioned variable
            self.entries[key.decode("utf-8")] = parse_entry(value)
        if header is None:
            raise CheckpointFormatError(f"{index}: no bundle header")
        self.num_shards, endianness = 1, 0
        for number, _, value in _fields(header):
            if number == 1:
                self.num_shards = value
            elif number == 2:
                endianness = value
        if endianness != 0:
            raise NotImplementedError(f"{index}: a big-endian bundle")
        for name, e in self.entries.items():
            if e.shard_id >= self.num_shards:
                raise CheckpointFormatError(
                    f"{index}: {name} in shard {e.shard_id} of "
                    f"{self.num_shards}")

    def shard_path(self, shard: int) -> str:
        return f"{self.prefix}.data-{shard:05d}-of-{self.num_shards:05d}"

    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {name: list(e.shape) for name, e in self.entries.items()}

    def get_variable_to_dtype_map(self) -> Dict[str, str]:
        """Each variable's dtype by TensorFlow's name (`DT_FLOAT`, ...)."""
        return {name: DTYPE_NAMES.get(e.dtype, f"dtype {e.dtype}")
                for name, e in self.entries.items()}

    def has_tensor(self, name: str) -> bool:
        return name in self.entries

    def get_tensor(self, name: str) -> np.ndarray:
        if name not in self.entries:
            raise KeyError(f"{name!r} is not in the checkpoint "
                           f"{self.prefix}")
        e = self.entries[name]
        if e.slices:
            raise NotImplementedError(f"{name}: a partitioned variable "
                                      f"({e.slices} slices)")
        if e.dtype not in DTYPES:
            raise NotImplementedError(
                f"{name}: {DTYPE_NAMES.get(e.dtype, f'dtype {e.dtype}')} is "
                f"not decoded by this reader")
        dtype = DTYPES[e.dtype]
        count = int(np.prod(e.shape, dtype=np.int64))
        if count * dtype.itemsize != e.size:
            raise CheckpointFormatError(
                f"{name}: {e.size} bytes for shape {e.shape} of {dtype}")
        path = self.shard_path(e.shard_id)
        with open(path, "rb") as fp:
            fp.seek(e.offset)
            data = fp.read(e.size)
        if len(data) != e.size:
            raise CheckpointFormatError(f"{path}: {name} runs past the end "
                                        f"of the shard")
        if masked_crc(self.crc(data)) != e.crc32c:
            raise CheckpointFormatError(f"{path}: bad CRC32C of {name}")
        return np.frombuffer(data, dtype).reshape(e.shape).copy()


_STATE_LINE = re.compile(r'^\s*model_checkpoint_path\s*:\s*(".*")\s*$')


def latest_checkpoint(directory: str) -> Optional[str]:
    """`tf.train.latest_checkpoint`: the prefix the directory's
    `checkpoint` state file names (joined to the directory when
    relative), or None when there is no state file or no index."""
    state = os.path.join(directory, "checkpoint")
    if not os.path.exists(state):
        return None
    with open(state, encoding="utf-8") as fp:
        for line in fp:
            m = _STATE_LINE.match(line)
            if m:
                path = ast.literal_eval("b" + m.group(1)).decode("utf-8")
                if not os.path.isabs(path):
                    path = os.path.join(directory, path)
                return path if os.path.exists(path + ".index") else None
    return None


def load_checkpoint(path: str, crc: Callable[[bytes], int] = crc32c_np
                    ) -> CheckpointReader:
    """`tf.train.load_checkpoint`: a prefix, or a directory whose latest
    checkpoint is read."""
    if os.path.isdir(path):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no tf.train checkpoint under {path}")
        path = latest
    return CheckpointReader(path, crc)
