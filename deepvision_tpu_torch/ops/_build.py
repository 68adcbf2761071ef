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

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build wall time, "ptxas": nvcc's resource report};
#: empty for a library that loaded from the cache
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels build from csrc/ at first use on a host with the CUDA "
            "toolkit")
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
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
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
    return lib
