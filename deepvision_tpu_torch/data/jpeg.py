"""JPEG decode for the port's input pipelines, on the card or the CPU.

The JAX pipelines decode with TensorFlow's host libjpeg
(`tf.io.decode_jpeg(..., channels=3)`, deepvision_tpu/data/imagenet.py:
65,86,104, detection.py:109, pose.py:88, gan.py:48) and PIL (the flat
loader). Here:

- on a CUDA device, nvJPEG through `csrc/jpeg_decode.cu` (a plain C
  interface loaded with ctypes, built with `-lnvjpeg` at first use):
  the baseline images the card's hardware JPEG decoders take as one
  batch on them, the other sequential ones as one batch through the
  GPU-assisted backend (the H100 of the port's chip runs has no
  hardware backend: every such image goes this way), progressive ones
  one by one through the default backend; interleaved RGB written into
  torch-allocated buffers on torch's current stream. The same library holds the batch's fused resample
  (`resample_batch`: crop, resize, flip, window, normalise or round to
  uint8) and the host CRC32C of the record reader (`host_crc32c`). A
  CUDA request that fails to build or to decode raises: it never falls
  back to PIL;
- on the CPU, PIL (`convert("RGB")`: grayscale to three channels, as
  `channels=3` does), which equals TensorFlow's decode with
  `dct_method="INTEGER_ACCURATE"` bit for bit, and `data/util.py`'s
  plain resample.

`extract_jpeg_shape` reads the frame header (SOF) in Python, as
`tf.io.extract_jpeg_shape` does, so crops are planned before the decode.
"""

from __future__ import annotations

import ctypes
import io
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .util import MODE_IDS, Emit, Plan, resample

# No JAX trace reaches this module (tests/test_torch_isolation.py);
# jaxlint's project-wide trace reach resolves calls by name.
# jaxlint: disable-file=EFF001,TRC001

#: SOF markers that carry a frame header (not DHT C4, JPG C8, DAC CC)
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF}
#: nvjpegChromaSubsampling_t of the encoder
CSS = {"444": 0, "422": 1, "420": 2, "gray": 6}

#: since the counts were last zeroed: decode calls, the images each route
#: took (the card's hardware decoder, its GPU-assisted batch, the default
#: backend one by one; PIL on the CPU), the compressed bytes decoded (on
#: the card, the bytes it received for them) and the resample's
#: descriptor bytes and launches
stats = {"decode_calls": 0, "hw_images": 0, "gpu_images": 0,
         "sw_images": 0, "cpu_images": 0, "compressed_bytes": 0,
         "descriptor_bytes": 0, "resample_launches": 0}


def images_decoded() -> int:
    """Images decoded by any route since the counts were zeroed."""
    return sum(stats[k] for k in ("hw_images", "gpu_images", "sw_images",
                                  "cpu_images"))


def extract_jpeg_shape(data: bytes) -> Tuple[int, int, int]:
    """(height, width, components) from the first frame header."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI marker)")
    pos, n = 2, len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        length = (data[pos + 2] << 8) | data[pos + 3]
        if marker in _SOF:
            if pos + 10 > n:
                break
            h = (data[pos + 5] << 8) | data[pos + 6]
            w = (data[pos + 7] << 8) | data[pos + 8]
            return h, w, data[pos + 9]
        if marker == 0xDA:          # start of scan before any frame
            break
        pos += 2 + length
    raise ValueError("JPEG stream without a frame header (SOF)")


def decode_cpu(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 through PIL, grayscale replicated."""
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        return np.array(im.convert("RGB"))


def encode_cpu(image: np.ndarray, quality: int = 90,
               subsampling: str = "420") -> bytes:
    """A JPEG of an (H, W, 3) or (H, W) uint8 image through PIL."""
    from PIL import Image
    buf = io.BytesIO()
    kw = dict(quality=quality)
    if image.ndim == 3:
        kw["subsampling"] = {"444": 0, "422": 1, "420": 2}[subsampling]
    Image.fromarray(image).save(buf, "JPEG", **kw)
    return buf.getvalue()


# -- the decoder library ------------------------------------------------------

_ptr = ctypes.c_void_p


class _Library:
    """The loaded `jpeg_decode` library and one nvJPEG decoder (its
    handles, states and encoder), used under a lock."""

    def __init__(self):
        from ..ops._build import load_library
        lib = load_library("jpeg_decode")
        lib.dv_jpeg_create.argtypes = [ctypes.POINTER(_ptr)] + [
            ctypes.POINTER(ctypes.c_int)] * 3
        lib.dv_jpeg_error.argtypes = [_ptr]
        lib.dv_jpeg_error.restype = ctypes.c_char_p
        lib.dv_jpeg_decode.argtypes = [_ptr, ctypes.c_int, _ptr, _ptr, _ptr,
                                       _ptr, _ptr, _ptr, _ptr]
        lib.dv_jpeg_encode.argtypes = [_ptr, _ptr, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _ptr, ctypes.c_size_t,
                                       ctypes.POINTER(ctypes.c_size_t), _ptr]
        lib.dv_resample.argtypes = [_ptr, _ptr, _ptr, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float, _ptr, _ptr, _ptr, _ptr]
        lib.dv_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_uint]
        lib.dv_crc32c.restype = ctypes.c_uint
        self.lib = lib
        self.lock = threading.Lock()
        self._handle = None
        #: backend -> created; backend -> took the interpolated chroma
        #: flag; the hardware backend's creation status (nvjpegStatus_t)
        self.backends: dict = {}
        self.interpolated: dict = {}
        self.hardware_status = None

    def handle(self):
        """The decoder, created on first use (a CUDA context exists)."""
        if self._handle is None:
            h = _ptr()
            bits, interp, hw = (ctypes.c_int(), ctypes.c_int(),
                                ctypes.c_int())
            rc = self.lib.dv_jpeg_create(ctypes.byref(h), ctypes.byref(bits),
                                         ctypes.byref(interp),
                                         ctypes.byref(hw))
            if rc != 0:
                raise RuntimeError("nvJPEG: " + self.error(h))
            self._handle = h
            names = {4: "hardware", 2: "gpu_hybrid", 1: "default"}
            self.backends = {v: bool(bits.value & k) for k, v in names.items()}
            self.interpolated = {v: bool(interp.value & k)
                                 for k, v in names.items()}
            self.hardware_status = hw.value
        return self._handle

    def error(self, h=None) -> str:
        return self.lib.dv_jpeg_error(h or self._handle).decode()

    def check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} failed (code {rc}): {self.error()}")


_LIB: Optional[_Library] = None
_LIB_LOCK = threading.Lock()


def library() -> _Library:
    """The process's decoder library, built and loaded on first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _Library()
        return _LIB


def host_crc32c(device: torch.device) -> Callable[[bytes], int]:
    """The record reader's data CRC: the library's SSE4.2 function where
    the pipeline runs on the card (the library is built there anyway),
    pure Python on the CPU."""
    if torch.device(device).type != "cuda":
        from .records import crc32c_py
        return crc32c_py
    lib = library().lib
    return lambda data: lib.dv_crc32c(data, len(data), 0)


def decoder_record() -> dict:
    """The decoder's library and route: the build (`compile_record`'s
    hit or miss), the hardware backend, the chroma upsampling, the
    counts."""
    from ..ops._build import LOADED
    lib = _LIB
    return {"library": "jpeg_decode",
            "build": LOADED.get("jpeg_decode", "not loaded"),
            "backends": None if lib is None else lib.backends,
            "hardware_status": None if lib is None else lib.hardware_status,
            "interpolated_chroma": None if lib is None else lib.interpolated,
            **stats}


def zero_stats() -> None:
    for k in stats:
        stats[k] = 0


# -- batch decode and resample ---------------------------------------------

class Decoded:
    """A batch of decoded images: on the card one flat uint8 buffer with
    each image's byte offset; on the CPU a list of (H, W, 3) tensors."""

    def __init__(self, shapes: List[Tuple[int, int]], flat=None,
                 offsets=None, images=None):
        self.shapes = shapes
        self.flat = flat
        self.offsets = offsets
        self.images = images

    def image(self, i: int) -> torch.Tensor:
        if self.images is not None:
            return self.images[i]
        h, w = self.shapes[i]
        o = int(self.offsets[i])
        return self.flat[o:o + h * w * 3].view(h, w, 3)


def decode_batch(datas: Sequence[bytes], device: torch.device,
                 shapes: Optional[Sequence[Tuple[int, int]]] = None
                 ) -> Decoded:
    """Decode `datas` (JPEG streams) on `device`. `shapes` (H, W) from
    `extract_jpeg_shape` where the caller has them."""
    device = torch.device(device)
    if shapes is None:
        shapes = [extract_jpeg_shape(d)[:2] for d in datas]
    shapes = [tuple(map(int, s)) for s in shapes]
    if device.type != "cuda":
        images = [torch.from_numpy(decode_cpu(d)) for d in datas]
        for d_img, s in zip(images, shapes):
            if tuple(d_img.shape[:2]) != s:
                raise ValueError(f"decoded {tuple(d_img.shape)}, the frame "
                                 f"header says {s}")
        stats["decode_calls"] += 1
        stats["cpu_images"] += len(datas)
        stats["compressed_bytes"] += int(sum(len(d) for d in datas))
        return Decoded(shapes, images=images)
    lib = library()
    sizes = np.array([h * w * 3 for h, w in shapes], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    flat = torch.empty(int(sizes.sum()), dtype=torch.uint8, device=device)
    n = len(datas)
    base = flat.data_ptr()
    data_p = (ctypes.c_char_p * n)(*datas)
    lens = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    outs = (_ptr * n)(*[base + int(o) for o in offsets])
    widths = (ctypes.c_int * n)(*[w for _, w in shapes])
    heights = (ctypes.c_int * n)(*[h for h, _ in shapes])
    routes = (ctypes.c_int * n)()
    with torch.cuda.device(device), lib.lock:
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lib.dv_jpeg_decode(lib.handle(), n, data_p, lens, outs,
                                    widths, heights, routes, _ptr(stream))
        lib.check(rc, "nvJPEG decode")
    routes = list(routes)
    stats["decode_calls"] += 1
    stats["hw_images"] += routes.count(2)
    stats["gpu_images"] += routes.count(1)
    stats["sw_images"] += routes.count(0)
    stats["compressed_bytes"] += int(sum(len(d) for d in datas))
    out = Decoded(shapes, flat=flat, offsets=offsets)
    out.keepalive = datas      # the streams, until the stream has run
    return out


def resample_batch(decoded: Decoded, plans: Sequence[Plan],
                   out_hw: Tuple[int, int], mode: str, how: Emit
                   ) -> torch.Tensor:
    """(B, H, W, 3) from a decoded batch, each image through its plan
    (`data/util.py::Plan`), emitted as `how` says: one launch of the
    library's resample kernel on the card, the plain version
    (`util.resample`) on the CPU."""
    if decoded.images is not None:
        return resample([decoded.image(i) for i in range(len(plans))],
                        plans, out_hw, mode, how)
    flat = decoded.flat
    device = flat.device
    n = len(plans)
    desc = np.zeros((n, 12), np.int32)
    for i, (p, (h, w)) in enumerate(zip(plans, decoded.shapes)):
        y, x, ch, cw = p.crop
        if not (0 <= y and 0 <= x and ch >= 1 and cw >= 1
                and y + ch <= h and x + cw <= w):
            raise ValueError(f"crop {p.crop} outside a {h}x{w} image")
        rh, rw = p.size
        oy, ox = p.window
        if oy < 0 or ox < 0 or oy + out_hw[0] > rh or ox + out_hw[1] > rw:
            raise ValueError(f"window {p.window} of a {p.size} resize does "
                             f"not hold {out_hw}")
        desc[i] = (h, w, y, x, ch, cw, rh, rw, oy, ox, int(p.flip), 0)
    desc_t = torch.from_numpy(desc).to(device)
    offs_t = torch.from_numpy(np.asarray(decoded.offsets, np.int64)).to(
        device)
    dtype = torch.uint8 if how.uint8 else torch.float32
    out = torch.empty((n, out_hw[0], out_hw[1], 3), dtype=dtype,
                      device=device)
    mean = (ctypes.c_float * 3)(*how.mean)
    std = (ctypes.c_float * 3)(*how.std)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lib.dv_resample(
            flat.data_ptr(), offs_t.data_ptr(), desc_t.data_ptr(), n,
            out_hw[0], out_hw[1], MODE_IDS[mode], int(how.uint8),
            int(how.clip), float(how.div), mean, std, out.data_ptr(),
            _ptr(stream))
    lib.check(rc, "resample launch")
    stats["resample_launches"] += 1
    stats["descriptor_bytes"] += desc.nbytes + 8 * n
    return out


def decode_resample(datas: Sequence[bytes], plans: Sequence[Plan],
                    shapes: Sequence[Tuple[int, int]], out_hw,
                    mode: str, how: Emit, device: torch.device
                    ) -> torch.Tensor:
    """Decode and resample one batch on `device`."""
    return resample_batch(decode_batch(datas, device, shapes), plans,
                          tuple(out_hw), mode, how)


def encode_jpeg(image: torch.Tensor, quality: int = 90,
                subsampling: str = "420") -> bytes:
    """A JPEG of an (H, W, 3) uint8 image (or (H, W) with
    `subsampling="gray"`): nvJPEG's encoder for a CUDA tensor, PIL for a
    CPU one. The smoke writes its records with it where PIL is absent."""
    if image.device.type != "cuda":
        return encode_cpu(image.numpy(), quality,
                          "420" if subsampling == "gray" else subsampling)
    gray = subsampling == "gray"
    if image.dtype != torch.uint8 or image.dim() != (2 if gray else 3) \
            or (not gray and image.shape[-1] != 3):
        raise ValueError(f"encode takes (H, W, 3) uint8 (or (H, W) gray), "
                         f"got {tuple(image.shape)} {image.dtype}")
    image = image.contiguous()
    h, w = image.shape[:2]
    lib = library()
    cap = h * w * 3 + 65536
    buf = ctypes.create_string_buffer(cap)
    length = ctypes.c_size_t()
    with torch.cuda.device(image.device), lib.lock:
        stream = torch.cuda.current_stream(image.device).cuda_stream
        rc = lib.lib.dv_jpeg_encode(lib.handle(), image.data_ptr(), w, h,
                                    quality, CSS[subsampling], buf, cap,
                                    ctypes.byref(length), _ptr(stream))
        lib.check(rc, "nvJPEG encode")
    return buf.raw[:length.value]
