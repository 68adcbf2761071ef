"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles with nvcc alone
into `<repo>/.cache/deepvision_tpu_torch/kernels/<name>-<hash>.so` (a
directory .gitignore lists), so no build includes PyTorch's headers. The
hash covers the source and the flags: an edited kernel rebuilds, an
unchanged one loads from the cache. Several sources build in parallel, one
nvcc process each (`build`). Nothing here runs at import time — this module
imports on hosts without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

# No JAX trace reaches this module (tests/test_torch_isolation.py); jaxlint's
# project-wide trace reach resolves calls by name and takes `build` for a
# traced function of the JAX package.
# jaxlint: disable-file=EFF001

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / ".cache"
             / "deepvision_tpu_torch" / "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: a source's own compile flags: the decoder library's host CRC32C takes
#: SSE4.2, and its resample computes its weights without multiply-add
#: contraction (data/util.py's float32 roundings, TensorFlow's table)
SOURCE_FLAGS: Dict[str, tuple] = {
    "jpeg_decode": ("-Xcompiler", "-msse4.2", "-fmad=false")}
#: a source's libraries, linked after the source (with an rpath to the
#: toolkit's lib64, where nvcc found them)
SOURCE_LIBS: Dict[str, tuple] = {"jpeg_decode": ("-lnvjpeg",)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build wall time, "ptxas": nvcc's resource report};
#: empty for a library that loaded from the cache
BUILD_INFO: Dict[str, dict] = {}
#: name -> "hit" (loaded from the cache) or "miss" (nvcc built it in this
#: process), for every library this process loaded: `compile_record`
LOADED: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels build from csrc/ at first use on a host with the CUDA "
            "toolkit")
    return path


def _flags(name: str) -> tuple:
    """Everything nvcc is given for `name` besides its output and source:
    (flags before the source, libraries after it)."""
    libs = SOURCE_LIBS.get(name, ())
    if libs:
        lib_dir = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                               "lib64")
        libs = ("-L" + lib_dir, *libs, "-Xlinker", "-rpath",
                "-Xlinker", lib_dir)
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ()), libs


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    before, after = _flags(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(before + after).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Sequence[str]) -> None:
    """Compile every named source whose library is not cached, all nvcc
    processes started together. Raises with nvcc's output on failure.
    Builders racing on one source (threads or processes) each write a
    private file and rename it into place, so the loser's rename swaps an
    identical library and a reader never sees a half-written one."""
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, so in todo:
        tmp = so.with_name(
            f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        before, after = _flags(name)
        cmd = [nvcc, *before, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *after]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, so)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                            "ptxas": out}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        with _lock:
            lib = _libs.setdefault(name, lib)
            LOADED.setdefault(name, "miss" if name in BUILD_INFO else "hit")
    return lib


def compile_record() -> dict:
    """What this process paid to load its kernel libraries: `entries`
    loaded, `cache_hits` (found in the cache), `cache_misses` (built here
    by nvcc) and `compile_s` (those builds' nvcc seconds), with each
    library's outcome. A serving replica puts it on /healthz, where a
    respawned replica on a warm cache shows `cache_misses == 0`."""
    with _lock:
        loaded = dict(LOADED)
    return {"entries": len(loaded),
            "cache_hits": sum(v == "hit" for v in loaded.values()),
            "cache_misses": sum(v == "miss" for v in loaded.values()),
            "compile_s": round(sum(BUILD_INFO[n]["seconds"]
                                   for n, v in loaded.items()
                                   if v == "miss"), 3),
            "libraries": loaded}
