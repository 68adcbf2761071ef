"""A PNG reader on zlib and numpy, for the card's re-encode of PNG sources
(nvJPEG reads JPEG only, and the card's machine has no PIL).

It reads what the dataset builders meet: 8-bit, non-interlaced gray,
RGB, RGBA and palette images, and returns (H, W, 3) uint8 RGB as PIL's
`convert("RGB")` does: gray replicated, alpha dropped, palette indices
looked up (an index past the palette reads black). Every other PNG (16
or fewer than 8 bits, interlaced, gray with alpha) is refused by name
(`UnsupportedPngError`), as is a stream whose chunk CRC or zlib data does
not check out.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> (name, samples a pixel)
COLOUR_TYPES = {0: ("gray", 1), 2: ("RGB", 3), 3: ("palette", 1),
                4: ("gray+alpha", 2), 6: ("RGBA", 4)}
READ = {0, 2, 3, 6}


class UnsupportedPngError(ValueError):
    """A PNG this reader does not decode, or a damaged one."""


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def png_header(data: bytes) -> Tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace) of the IHDR."""
    if not is_png(data):
        raise UnsupportedPngError("not a PNG stream (no signature)")
    if data[12:16] != b"IHDR" or len(data) < 29:
        raise UnsupportedPngError("a PNG stream without its IHDR chunk")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        data[16:29])
    return w, h, depth, ctype, interlace


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines of `raw` (a filter byte then `stride` bytes each)
    reconstructed (PNG's filters None, Sub, Up, Average, Paeth)."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:        # Sub: a running sum per byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:        # Up
            cur = line + prior
        elif ftype in (3, 4):   # Average, Paeth: byte after byte
            cur = _left_dependent(ftype, line.tolist(), prior.tolist(), bpp)
        else:
            raise UnsupportedPngError(f"unknown PNG filter type {ftype} "
                                      f"in row {y}")
        out[y] = cur
        prior = cur
    return out


def _left_dependent(ftype: int, line: list, up: list, bpp: int
                    ) -> np.ndarray:
    """One Average (3) or Paeth (4) scanline, in Python integers (each
    byte depends on the one reconstructed `bpp` before it)."""
    cur = line
    for j in range(len(cur)):
        a = cur[j - bpp] if j >= bpp else 0
        b = up[j]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[j - bpp] if j >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[j] = (cur[j] + pred) & 0xFF
    return np.array(cur, np.uint8)


def read_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG stream (see the module's limits)."""
    w, h, depth, ctype, interlace = png_header(data)
    name = COLOUR_TYPES.get(ctype, (f"colour type {ctype}", 0))[0]
    if ctype not in READ or depth != 8 or interlace != 0:
        raise UnsupportedPngError(
            f"{name} PNG at {depth} bits"
            f"{', interlaced' if interlace else ''}: "
            f"the reader takes 8-bit non-interlaced gray, RGB, RGBA and "
            f"palette PNGs; convert it to one of those or to JPEG")
    idat, palette, pos = [], None, 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:
                                          pos + 12 + length] or b"\0" * 4)
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise UnsupportedPngError(f"PNG chunk {kind!r} at byte {pos} "
                                      f"is truncated or fails its CRC")
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IEND":
            break
        pos += 12 + length
    samples = COLOUR_TYPES[ctype][1]
    stride = w * samples
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise UnsupportedPngError(f"PNG image data: {e}") from None
    if raw.size < h * (stride + 1):
        raise UnsupportedPngError(f"PNG image data holds {raw.size} bytes, "
                                  f"{h} rows need {h * (stride + 1)}")
    pixels = _unfilter(raw[:h * (stride + 1)], h, stride,
                       samples).reshape(h, w, samples)
    if ctype == 0:
        return np.repeat(pixels, 3, axis=2)
    if ctype == 2:
        return pixels
    if ctype == 6:
        return np.ascontiguousarray(pixels[..., :3])
    if palette is None:
        raise UnsupportedPngError("a palette PNG without its PLTE chunk")
    table = np.zeros((256, 3), np.uint8)
    table[:len(palette)] = palette[:256]
    return table[pixels[..., 0]]
