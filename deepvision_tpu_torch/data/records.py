"""TFRecord files and `tf.train.Example` protos without TensorFlow (the
port's counterpart of `tf.data.TFRecordDataset`, `tf.io.parse_single_example`
and `tf.io.TFRecordWriter`).

A record is framed as TFRecord writes it: the data length as a
little-endian u64, the masked CRC32C of those 8 bytes, the data, the
masked CRC32C of the data. A record whose length or data does not match
its CRC raises `CorruptRecordError`, naming the file and the byte offset;
nothing past it is yielded. The data CRC is computed by `crc` (a callable
`crc(bytes) -> int`): `crc32c_py` here, or the SSE4.2 host function of the
decoder's library (`data/jpeg.py::host_crc32c`) where the loader runs on
the card.

An Example is parsed straight from its protobuf wire format: the features
map, `bytes_list`, and packed or unpacked `float_list` and `int64_list`.
Packed floats go to `np.frombuffer`, packed varints are decoded with numpy
in one pass. The writer (`encode_example`, `write_records`) packs as
TensorFlow does; the tests and `chip_smoke.py` write their fixtures with it.

File order follows the JAX pipelines' `list_files(pattern, shuffle=
training, seed=seed)` then `.shard(world, rank)` (`list_files`): sorted in
eval, so a rank's files equal JAX's; shuffled by the port's own seeded
generator in training (TF's shuffle of the names cannot be reproduced),
where the ranks' files are disjoint and cover the pattern. A remote
pattern or file (gs://, s3://, memory://, file://) is read and written
through fsspec (`data/fs.py`), and refused by name where the package of
its protocol is absent.
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, Iterable, Iterator, List, NamedTuple, \
    Optional, Sequence, Tuple, Union

import numpy as np

from . import fs

# -- CRC32C (Castagnoli), as TFRecord masks it ------------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)
del _i, _c


def crc32c_py(data: bytes, crc: int = 0) -> int:
    """CRC32C of `data`, byte by byte in Python (about 10 MB/s: the
    tests' and the CPU path's; the card's loader uses the C function)."""
    crc ^= 0xFFFFFFFF
    table = _TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(crc: int) -> int:
    """TFRecord's mask: rotate right by 15, add a constant (mod 2^32)."""
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class CorruptRecordError(ValueError):
    """A record whose framing or CRC does not check out."""


# -- record framing ----------------------------------------------------------

def read_records(path: str, crc: Callable[[bytes], int] = crc32c_py,
                 check_data: bool = True) -> Iterator[bytes]:
    """The records of one TFRecord file, in order. Raises
    `CorruptRecordError` (file and byte offset) on a bad length CRC, a
    truncated record or a bad data CRC."""
    with fs.open(path, "rb") as f:
        offset = 0
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise CorruptRecordError(
                    f"{path}: truncated record header at byte {offset}")
            (length,) = struct.unpack("<Q", head[:8])
            (len_crc,) = struct.unpack("<I", head[8:])
            if masked_crc(crc32c_py(head[:8])) != len_crc:
                raise CorruptRecordError(
                    f"{path}: bad length CRC at byte {offset}")
            body = f.read(length + 4)
            if len(body) < length + 4:
                raise CorruptRecordError(
                    f"{path}: truncated record at byte {offset} (length "
                    f"{length}, {len(body)} bytes left)")
            data = body[:length]
            if check_data:
                (data_crc,) = struct.unpack("<I", body[length:])
                if masked_crc(crc(data)) != data_crc:
                    raise CorruptRecordError(
                        f"{path}: bad data CRC in the record at byte "
                        f"{offset}")
            yield data
            offset += 12 + length + 4


def frame_record(data: bytes,
                 crc: Callable[[bytes], int] = crc32c_py) -> bytes:
    """One record as TFRecordWriter frames it (`crc` computes the data's
    CRC32C, as in `read_records`)."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc(crc32c_py(length)))
            + data + struct.pack("<I", masked_crc(crc(data))))


def write_records(path: str, records: Iterable[bytes],
                  crc: Callable[[bytes], int] = crc32c_py) -> int:
    """Write `records` to one TFRecord file (local or remote); returns
    how many."""
    n = 0
    with fs.open(path, "wb") as f:
        for data in records:
            f.write(frame_record(data, crc))
            n += 1
    return n


# -- tf.train.Example wire format --------------------------------------------

class Feature(NamedTuple):
    """One feature: `kind` is "bytes", "float" or "int64"; `values` a list
    of bytes or a 1-D numpy array (float32 or int64)."""
    kind: str
    values: Union[List[bytes], np.ndarray]


def bytes_feature(values: Union[bytes, Sequence[bytes]]) -> Feature:
    return Feature("bytes", [values] if isinstance(values, bytes)
                   else list(values))


def float_feature(values) -> Feature:
    return Feature("float", np.atleast_1d(np.asarray(values, np.float32)))


def int64_feature(values) -> Feature:
    return Feature("int64", np.atleast_1d(np.asarray(values, np.int64)))


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _enc_varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _fields(buf) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a message (a memoryview, so no
    field is copied): an int for varints, a view of a length-delimited
    field, of a fixed one."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _varint(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _varint(buf, pos)
        elif wt == 2:
            ln, pos = _varint(buf, pos)
            val = buf[pos:pos + ln]
            if len(val) != ln:
                raise ValueError("truncated length-delimited field")
            pos += ln
        elif wt == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wt == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield num, wt, val


def decode_varints(buf) -> np.ndarray:
    """A packed run of varints as int64, in one numpy pass (negative
    int64s are 10-byte two's-complement varints); a single one directly."""
    b = np.frombuffer(buf, np.uint8)
    if b.size == 0:
        return np.zeros((0,), np.int64)
    if b[-1] < 0x80 and (b.size == 1 or (b.size <= 10 and (
            b[:-1] >= 0x80).all())):
        value, _ = _varint(buf, 0)
        return np.array([value], np.uint64).view(np.int64)
    ends = np.flatnonzero(b < 0x80)
    if ends.size == 0 or ends[-1] != b.size - 1:
        raise ValueError("truncated packed varint")
    starts = np.concatenate([[0], ends[:-1] + 1])
    group = np.repeat(np.arange(ends.size), ends - starts + 1)
    shift = (np.arange(b.size) - starts[group]).astype(np.uint64) * \
        np.uint64(7)
    parts = (b & 0x7F).astype(np.uint64) << shift
    return np.add.reduceat(parts, starts).view(np.int64)


def _parse_float_list(buf: bytes) -> np.ndarray:
    chunks = []
    for num, wt, val in _fields(buf):
        if num != 1:
            continue
        if wt == 2:                                     # packed
            chunks.append(np.frombuffer(val, "<f4"))
        elif wt == 5:                                   # unpacked
            chunks.append(np.frombuffer(val, "<f4"))
    return (np.concatenate(chunks).astype(np.float32) if chunks
            else np.zeros((0,), np.float32))


def _parse_int64_list(buf: bytes) -> np.ndarray:
    chunks = []
    for num, wt, val in _fields(buf):
        if num != 1:
            continue
        if wt == 2:                                     # packed
            chunks.append(decode_varints(val))
        elif wt == 0:                                   # unpacked
            chunks.append(np.array([val], np.uint64).view(np.int64))
    return (np.concatenate(chunks) if chunks
            else np.zeros((0,), np.int64))


def parse_example(serialized: bytes) -> Dict[str, Feature]:
    """A serialized `tf.train.Example` as {key: Feature}."""
    out: Dict[str, Feature] = {}
    for num, wt, features in _fields(memoryview(serialized)):
        if num != 1 or wt != 2:
            continue
        for fnum, fwt, entry in _fields(features):
            if fnum != 1 or fwt != 2:
                continue
            key, feat = None, b""
            for enum, _, val in _fields(entry):
                if enum == 1:
                    key = bytes(val).decode("utf-8")
                elif enum == 2:
                    feat = val
            if key is None:
                continue
            parsed = Feature("bytes", [])
            for knum, kwt, lst in _fields(feat):
                if kwt != 2:
                    continue
                if knum == 1:
                    parsed = Feature("bytes", [bytes(v) for n, _, v in
                                               _fields(lst) if n == 1])
                elif knum == 2:
                    parsed = Feature("float", _parse_float_list(lst))
                elif knum == 3:
                    parsed = Feature("int64", _parse_int64_list(lst))
            out[key] = parsed
    return out


def _ld(num: int, payload: bytes) -> bytes:
    return _enc_varint((num << 3) | 2) + _enc_varint(len(payload)) + payload


def encode_example(features: Dict[str, Feature]) -> bytes:
    """A `tf.train.Example` from {key: Feature}, lists packed as
    TensorFlow packs them."""
    entries = []
    for key, feat in features.items():
        if feat.kind == "bytes":
            lst = b"".join(_ld(1, v) for v in feat.values)
            body = _ld(1, lst)
        elif feat.kind == "float":
            vals = np.asarray(feat.values, "<f4").tobytes()
            body = _ld(2, _ld(1, vals) if vals else b"")
        elif feat.kind == "int64":
            vals = b"".join(_enc_varint(int(v)) for v in feat.values)
            body = _ld(3, _ld(1, vals) if vals else b"")
        else:
            raise ValueError(f"unknown feature kind {feat.kind!r}")
        entries.append(_ld(1, _ld(1, key.encode("utf-8")) + _ld(2, body)))
    return _ld(1, b"".join(entries))


def feature_values(parsed: Dict[str, Feature], key: str, kind: str,
                   default=None):
    """`parsed[key]`'s values, or `default` (an empty list of `kind` when
    None) where the key is absent: `VarLenFeature`'s contract."""
    feat = parsed.get(key)
    if feat is None or (feat.kind != kind and len(feat.values) == 0):
        if default is not None:
            return default
        return ([] if kind == "bytes" else
                np.zeros((0,), np.float32 if kind == "float" else np.int64))
    if feat.kind != kind:
        raise ValueError(f"feature {key!r} is {feat.kind}, not {kind}")
    return feat.values


# -- file lists ---------------------------------------------------------------

def list_files(pattern: str, *, training: bool, seed: int = 0,
               world: int = 1, rank: int = 0) -> List[str]:
    """The files of `pattern` this rank reads: sorted, shuffled by
    `np.random.default_rng(seed)` when training, then every `world`-th
    from `rank` (`files.shard(world, rank)`). A remote pattern lists
    through fsspec (`fs.glob`); a pattern that matches nothing raises."""
    files = fs.glob(pattern)
    if not files:
        raise FileNotFoundError(f"no files match {pattern!r}")
    if training:
        order = np.random.default_rng(seed).permutation(len(files))
        files = [files[i] for i in order]
    return files[rank::world]


def interleave(files: Sequence[str], *, cycle_length: int,
               block_length: int, reader: Callable[[str], Iterator[bytes]]
               ) -> Iterator[bytes]:
    """`Dataset.interleave(cycle_length, block_length)` in its
    deterministic order: slots opened lazily in file order, `block_length`
    records from each slot in turn; an exhausted slot is closed and its
    turn passes, and it is refilled with the next file when the cycle
    comes back to it."""
    pending = iter(files)
    slots: List[Optional[Iterator[bytes]]] = [None] * cycle_length
    end_of_input, n_open, idx, block = False, 0, 0, 0
    while not end_of_input or n_open > 0:
        it = slots[idx]
        if it is not None:
            rec = next(it, None)
            if rec is not None:
                block += 1
                if block == block_length:
                    block, idx = 0, (idx + 1) % cycle_length
                yield rec
                continue
            slots[idx] = None
            n_open -= 1
            block, idx = 0, (idx + 1) % cycle_length
        elif not end_of_input:
            path = next(pending, None)
            if path is None:
                end_of_input = True
                continue
            slots[idx] = reader(path)
            n_open += 1
        else:
            block, idx = 0, (idx + 1) % cycle_length


def shuffle_buffer(records: Iterable, size: int,
                   rng: np.random.Generator) -> Iterator:
    """`Dataset.shuffle(size)`'s contract with the port's generator: a
    buffer of `size` elements, each output drawn uniformly from it and
    its slot refilled from the input."""
    buf: list = []
    for rec in records:
        if len(buf) < size:
            buf.append(rec)
            continue
        i = int(rng.integers(len(buf)))
        buf[i], rec = rec, buf[i]
        yield rec
    order = rng.permutation(len(buf))
    for i in order:
        yield buf[i]
