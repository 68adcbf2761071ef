"""A read-only HDF5 reader for the layout h5py writes by default
(`libver="earliest"`), without h5py: the port's way into the reference's
Keras `save_weights` files on a machine that has no h5py.

Each level of the format has its own reader here:
- the superblock, version 0 or 1 (at byte 0 or after a user block of
  512, 1024, ... bytes), with its root group's symbol-table entry;
- version-1 object headers: messages 8-byte aligned, continuation
  messages (0x0010) followed into their blocks;
- old-style groups: the symbol-table message (0x0011) names a v1 B-tree
  ("TREE", type 0, any number of levels) and a local heap ("HEAP"); the
  B-tree's leaves are symbol-table nodes ("SNOD") whose entries name the
  group's members and their object headers;
- datasets: dataspace (0x0001, versions 1 and 2), datatype (0x0003:
  little-endian IEEE float of 2, 4 or 8 bytes, and fixed-point integers
  of 1, 2, 4 or 8 bytes), fill value (0x0005, for storage never
  written), and layout (0x0008) version 3, contiguous or compact.
  Attributes are skipped: the Keras loader never reads them.

What the reader does not know it refuses with `NotImplementedError`,
naming the object's path: chunked storage and filter pipelines (0x000B,
gzip and the like), superblocks 2 and 3 and "OHDR" (version 2) object
headers (`libver="latest"`), new-style groups (link and link-info
messages: `track_order=True`), shared (committed) datatypes, big-endian
or non-IEEE data, and every datatype class but integers and floats. It
never returns an array it has not read as the file describes it.

`visit_datasets(path)` yields `(name, array)` for every dataset in the
order h5py's `visititems` visits them: depth first, each group's members
in the B-tree's order (byte order of their names), an object reached
twice by hard links visited once.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, List, Optional, Set, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types
DATASPACE, LINK_INFO, DATATYPE, FILL, LINK, LAYOUT = 1, 2, 3, 5, 6, 8
FILTERS, CONTINUATION, SYMBOL_TABLE = 11, 16, 17
_MESSAGE_SHARED = 0x02

# (size, exponent location, exponent size, mantissa size, bias) of IEEE
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


class H5FormatError(ValueError):
    """The bytes are not the structure the format puts there."""


class _File:
    """Offsets and lengths as the superblock sizes them, over a file."""

    def __init__(self, fp: BinaryIO, path: str):
        self.fp, self.path = fp, path
        self.base = self._find_superblock()
        head = self._read(self.base + 8, 16)
        version = head[0]
        if version not in (0, 1):
            raise NotImplementedError(
                f"{path}: superblock version {version} (files written with "
                f"libver='latest' or 'v108'+); this reader knows versions "
                f"0 and 1, h5py's default layout")
        self.so, self.sl = head[5], head[6]
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise H5FormatError(f"{path}: offset size {self.so}, length "
                                f"size {self.sl}")
        at = self.base + 8 + 16 + (4 if version == 1 else 0)
        (base_address, _free, _eof, _driver), at = self.offsets(at, 4)
        # addresses are relative to the base address (the superblock's
        # own position unless a user block moved it)
        self.base = base_address
        self.root = self._symbol_entry(at)

    def _find_superblock(self) -> int:
        at = 0
        while True:
            sig = self._read(at, 8, what="superblock")
            if sig == SIGNATURE:
                return at
            at = 512 if at == 0 else at * 2
            self.fp.seek(0, 2)
            if at >= self.fp.tell():
                raise H5FormatError(f"{self.path}: no HDF5 signature")

    def _read(self, at: int, n: int, what: str = "structure") -> bytes:
        self.fp.seek(at)
        data = self.fp.read(n)
        if len(data) != n:
            raise H5FormatError(f"{self.path}: {what} at byte {at} runs "
                                f"past the end of the file")
        return data

    def read(self, address: int, n: int, what: str = "structure") -> bytes:
        return self._read(self.base + address, n, what)

    def _uint(self, data: bytes, at: int, size: int) -> int:
        return int.from_bytes(data[at:at + size], "little")

    def offsets(self, at: int, n: int) -> Tuple[List[int], int]:
        """`n` offset-sized integers from absolute byte `at`; the values
        and the byte after them."""
        data = self._read(at, n * self.so)
        return [self._uint(data, i * self.so, self.so)
                for i in range(n)], at + n * self.so

    def offset(self, data: bytes, at: int) -> int:
        value = self._uint(data, at, self.so)
        return UNDEFINED if value == (1 << (8 * self.so)) - 1 else value

    def length(self, data: bytes, at: int) -> int:
        return self._uint(data, at, self.sl)

    def _symbol_entry(self, at: int) -> Tuple[int, int, int]:
        """(link name offset, object header address, cache type) of a
        symbol-table entry at absolute byte `at`; cache type 2 is a soft
        link, whose header address is undefined."""
        data = self._read(at, 2 * self.so + 4)
        return (self.offset(data, 0), self.offset(data, self.so),
                int.from_bytes(data[2 * self.so:], "little"))

    @property
    def entry_size(self) -> int:
        return 2 * self.so + 4 + 4 + 16


class _Header:
    """The messages of one version-1 object header, continuations
    followed: a list of (type, flags, data)."""

    def __init__(self, f: _File, address: int, path: str):
        self.path = path
        prefix = f.read(address, 16, "object header")
        if prefix[:4] == b"OHDR":
            raise NotImplementedError(
                f"{f.path}:{path}: version 2 object header ('OHDR': "
                f"libver='latest', or track_order=True); this reader knows "
                f"version 1 headers")
        if prefix[0] != 1:
            raise H5FormatError(f"{f.path}:{path}: object header version "
                                f"{prefix[0]}")
        count = struct.unpack_from("<H", prefix, 2)[0]
        size = struct.unpack_from("<I", prefix, 8)[0]
        self.messages: List[Tuple[int, int, bytes]] = []
        # the messages start after the 12-byte prefix, padded to 8
        blocks = [(address + 16, size)]
        while blocks and len(self.messages) < count:
            start, length = blocks.pop(0)
            block = f.read(start, length, "object header messages")
            at = 0
            while at + 8 <= length and len(self.messages) < count:
                mtype, msize, flags = struct.unpack_from("<HHB", block, at)
                data = block[at + 8:at + 8 + msize]
                if len(data) != msize:
                    raise H5FormatError(f"{f.path}:{path}: message of type "
                                        f"{mtype:#x} overruns its header")
                self.messages.append((mtype, flags, data))
                if mtype == CONTINUATION:
                    blocks.append((f.offset(data, 0),
                                   f.length(data, f.so)))
                at += 8 + msize
        if len(self.messages) != count:
            raise H5FormatError(f"{f.path}:{path}: {len(self.messages)} of "
                                f"{count} header messages found")

    def find(self, mtype: int) -> Optional[Tuple[int, bytes]]:
        for t, flags, data in self.messages:
            if t == mtype:
                return flags, data
        return None

    def types(self) -> Set[int]:
        return {t for t, _, _ in self.messages}


def _dataspace(data: bytes, f: _File, where: str) -> Tuple[int, ...]:
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        at = 8
    elif version == 2:
        if data[3] == 2:     # the null dataspace holds no element
            raise NotImplementedError(f"{where}: null dataspace")
        at = 4
    else:
        raise NotImplementedError(f"{where}: dataspace version {version}")
    return tuple(f.length(data, at + i * f.sl) for i in range(rank))


def _datatype(data: bytes, where: str) -> np.dtype:
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits = data[1] | data[2] << 8 | data[3] << 16
    size = struct.unpack_from("<I", data, 4)[0]
    if version not in (1, 2, 3):
        raise H5FormatError(f"{where}: datatype version {version}")
    if cls == 0:                          # fixed-point
        if bits & 1:
            raise NotImplementedError(f"{where}: big-endian integer data")
        offset, precision = struct.unpack_from("<HH", data, 8)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise NotImplementedError(
                f"{where}: integer of {size} bytes, bit offset {offset}, "
                f"precision {precision}")
        return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:                          # floating point
        if bits & 1 or bits & 0x40:
            raise NotImplementedError(f"{where}: big-endian (or VAX-order) "
                                      f"float data")
        if size not in _IEEE:
            raise NotImplementedError(f"{where}: float of {size} bytes")
        offset, precision, exp_at, exp_size, mant_at, mant_size, bias = \
            struct.unpack_from("<HHBBBBI", data, 8)
        if (offset, precision, mant_at) != (0, 8 * size, 0) or \
                (exp_at, exp_size, mant_size, bias) != _IEEE[size]:
            raise NotImplementedError(f"{where}: a {size}-byte float that "
                                      f"is not IEEE 754's")
        return np.dtype(f"<f{size}")
    names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
             6: "compound", 7: "reference", 8: "enum (h5py's bool)",
             9: "variable-length", 10: "array"}
    raise NotImplementedError(f"{where}: datatype class {cls} "
                              f"({names.get(cls, 'unknown')})")


def _fill_value(header: _Header, dtype: np.dtype) -> Optional[bytes]:
    """The fill value's bytes where the header defines one."""
    found = header.find(FILL)
    if found is None:
        return None
    data = found[1]
    version = data[0]
    if version in (1, 2):
        if not data[3]:
            return None
        at = 4
    else:                                  # version 3: flags bit 5
        if not data[1] & 0x20:
            return None
        at = 2
    size = struct.unpack_from("<I", data, at)[0]
    return data[at + 4:at + 4 + size] if size == dtype.itemsize else None


def _read_dataset(f: _File, header: _Header, where: str) -> np.ndarray:
    types = header.types()
    if FILTERS in types:
        raise NotImplementedError(f"{where}: filter pipeline (compression "
                                  f"or checksums on chunks)")
    for mtype, what in ((DATASPACE, "dataspace"), (DATATYPE, "datatype")):
        found = header.find(mtype)
        if found is None:
            raise H5FormatError(f"{where}: dataset without a {what} message")
        if found[0] & _MESSAGE_SHARED:
            raise NotImplementedError(f"{where}: shared (committed) {what}")
    shape = _dataspace(header.find(DATASPACE)[1], f, where)
    dtype = _datatype(header.find(DATATYPE)[1], where)
    found = header.find(LAYOUT)
    if found is None:
        raise H5FormatError(f"{where}: dataset without a layout message")
    layout = found[1]
    if layout[0] != 3:
        raise NotImplementedError(f"{where}: layout message version "
                                  f"{layout[0]}; this reader knows version 3")
    count = int(np.prod(shape, dtype=np.int64))
    nbytes = count * dtype.itemsize
    if layout[1] == 0:                     # compact: the bytes are here
        size = struct.unpack_from("<H", layout, 2)[0]
        raw = layout[4:4 + size]
        if size != nbytes or len(raw) != size:
            raise H5FormatError(f"{where}: compact data of {size} bytes "
                                f"for {nbytes}")
        return np.frombuffer(raw, dtype).reshape(shape).copy()
    if layout[1] == 2:
        raise NotImplementedError(f"{where}: chunked storage")
    if layout[1] != 1:
        raise NotImplementedError(f"{where}: layout class {layout[1]}")
    address = f.offset(layout, 2)
    size = f.length(layout, 2 + f.so)
    if address == UNDEFINED:               # never written: the fill value
        fill = _fill_value(header, dtype)
        if fill is None:
            return np.zeros(shape, dtype)
        return np.full(shape, np.frombuffer(fill, dtype)[0], dtype)
    if size != nbytes:
        raise H5FormatError(f"{where}: contiguous data of {size} bytes for "
                            f"{nbytes}")
    f.fp.seek(f.base + address)
    out = np.fromfile(f.fp, dtype, count) if count else np.empty(0, dtype)
    if out.size != count:
        raise H5FormatError(f"{where}: data runs past the end of the file")
    return out.reshape(shape)


def _heap_data(f: _File, address: int, where: str) -> bytes:
    head = f.read(address, 8 + 2 * f.sl + f.so, "local heap")
    if head[:4] != b"HEAP":
        raise H5FormatError(f"{where}: no local heap at {address}")
    size = f.length(head, 8)
    data_at = f.offset(head, 8 + 2 * f.sl)
    return f.read(data_at, size, "local heap data")


def _heap_name(heap: bytes, offset: int, where: str) -> str:
    end = heap.find(b"\0", offset)
    if end < 0:
        raise H5FormatError(f"{where}: name at heap offset {offset} is not "
                            f"terminated")
    return heap[offset:end].decode("utf-8")


def _group_members(f: _File, btree: int, heap: bytes,
                   where: str) -> Iterator[Tuple[str, int]]:
    """(name, object header address) of a group's members, in the
    B-tree's order, every level walked; soft links are passed over, as
    h5py's `visititems` passes them."""
    head_size = 8 + 2 * f.so
    node = f.read(btree, head_size, "B-tree node")
    if node[:4] != b"TREE":
        raise H5FormatError(f"{where}: no B-tree node at {btree}")
    if node[4] != 0:
        raise H5FormatError(f"{where}: B-tree of type {node[4]} where a "
                            f"group's (0) belongs")
    level, entries = node[5], struct.unpack_from("<H", node, 6)[0]
    # keys (length-sized heap offsets) and children interleaved
    body = f.read(btree + head_size, entries * (f.sl + f.so) + f.sl,
                  "B-tree entries")
    children = [f.offset(body, f.sl + i * (f.sl + f.so))
                for i in range(entries)]
    for child in children:
        if level > 0:
            yield from _group_members(f, child, heap, where)
            continue
        snod = f.read(child, 8, "symbol node")
        if snod[:4] != b"SNOD":
            raise H5FormatError(f"{where}: no symbol node at {child}")
        n = struct.unpack_from("<H", snod, 6)[0]
        for i in range(n):
            name_at, header, cache = f._symbol_entry(
                f.base + child + 8 + i * f.entry_size)
            if cache != 2:
                yield _heap_name(heap, name_at, where), header


def _walk(f: _File, address: int, path: str, seen: Set[int]
          ) -> Iterator[Tuple[str, np.ndarray]]:
    """The datasets under the group at `address` (`path` its name),
    depth first in member order, each object once."""
    header = _Header(f, address, path or "/")
    where = f"{f.path}:{path or '/'}"
    types = header.types()
    if LINK in types or LINK_INFO in types:
        raise NotImplementedError(
            f"{where}: new-style group (link messages: track_order=True "
            f"or libver='latest'); this reader knows symbol-table groups")
    found = header.find(SYMBOL_TABLE)
    if found is None:
        raise H5FormatError(f"{where}: group without a symbol table")
    btree, heap_at = f.offset(found[1], 0), f.offset(found[1], f.so)
    heap = _heap_data(f, heap_at, where)
    for name, child in list(_group_members(f, btree, heap, where)):
        if child in seen:
            continue
        seen.add(child)
        child_path = f"{path}/{name}" if path else name
        member = _Header(f, child, child_path)
        mtypes = member.types()
        if SYMBOL_TABLE in mtypes or LINK in mtypes or LINK_INFO in mtypes:
            yield from _walk(f, child, child_path, seen)
        elif LAYOUT in mtypes or DATASPACE in mtypes:
            yield child_path, _read_dataset(f, member,
                                            f"{f.path}:{child_path}")
        # a committed datatype is neither: nothing to read


def visit_datasets(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """(name, array) for every dataset of the HDF5 file at `path`, in the
    order of h5py's `visititems` (names relative to the root, as h5py
    gives them)."""
    with open(path, "rb") as fp:
        f = _File(fp, path)
        root = f.root[1]
        yield from _walk(f, root, "", {root})
