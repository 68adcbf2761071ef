"""Local and remote paths for the record readers, the flat loader and the
dataset builders (the part of `tf.io.gfile` the JAX package reaches
through `tf.data` and `tf.io.TFRecordWriter`).

A path without `://` is local and goes through `os` and `open`. A URL
(`gs://`, `s3://`, `memory://`, `file://`, ...) goes through `fsspec`,
and the package that serves its protocol must be installed: `gs://`
without `gcsfs` is refused by name (`RemotePathError`), as is every
protocol fsspec does not know. Globs come back as URLs of the same
protocol, sorted, so a remote pattern lists in the order a local one
does. `copytree` is the export's upload (`gsutil cp -r` in the JAX
package's Hourglass/jax/main.py).
"""

from __future__ import annotations

import builtins
import glob as _glob
import importlib
import os
import shutil
from typing import IO, List, Tuple


class RemotePathError(ValueError):
    """A remote path whose protocol cannot be served here."""


def is_remote(path: str) -> bool:
    return "://" in path


def filesystem(url: str) -> Tuple[object, str]:
    """(fsspec file system, path within it) of a URL; refuses by name a
    protocol whose package is absent."""
    protocol = url.split("://", 1)[0]
    try:
        import fsspec
        from fsspec.registry import known_implementations
    except ImportError:
        raise RemotePathError(
            f"{url!r} is a remote path, read through fsspec, which is not "
            f"installed") from None
    impl = known_implementations.get(protocol)
    if impl is None and protocol not in fsspec.available_protocols():
        raise RemotePathError(f"{url!r}: fsspec knows no protocol "
                              f"{protocol!r}")
    if impl is not None:
        package = impl["class"].split(".")[0]
        try:
            importlib.import_module(package)
        except ImportError:
            raise RemotePathError(
                f"{url!r}: the {protocol}:// protocol needs the {package!r} "
                f"package, which is not installed; install it or copy the "
                f"files to a local directory") from None
    return fsspec.core.url_to_fs(url)


def glob(pattern: str) -> List[str]:
    """The paths matching `pattern`, sorted (URLs for a remote one)."""
    if not is_remote(pattern):
        return sorted(_glob.glob(pattern))
    fs, path = filesystem(pattern)
    return sorted(fs.unstrip_protocol(p) for p in fs.glob(path))


def open(path: str, mode: str = "rb") -> IO:
    """A file object of `path` (binary modes)."""
    if not is_remote(path):
        return builtins.open(path, mode)
    fs, p = filesystem(path)
    return fs.open(p, mode)


def listdir(path: str) -> List[str]:
    """The names of the entries of directory `path`."""
    if not is_remote(path):
        return os.listdir(path)
    fs, p = filesystem(path)
    return [e.rstrip("/").rsplit("/", 1)[-1]
            for e in fs.ls(p, detail=False)]


def isdir(path: str) -> bool:
    if not is_remote(path):
        return os.path.isdir(path)
    fs, p = filesystem(path)
    return fs.isdir(p)


def makedirs(path: str) -> None:
    if not is_remote(path):
        os.makedirs(path, exist_ok=True)
        return
    fs, p = filesystem(path)
    fs.makedirs(p, exist_ok=True)


def join(base: str, *parts: str) -> str:
    """`os.path.join` for a local base; '/'-joined for a URL."""
    if not is_remote(base):
        return os.path.join(base, *parts)
    return "/".join([base.rstrip("/"), *parts])


def basename(path: str) -> str:
    return path.rstrip("/").rsplit("/", 1)[-1] if is_remote(path) \
        else os.path.basename(path)


def copytree(src: str, dst: str) -> str:
    """Copy the local directory `src`, file for file, to `dst` (a local
    path or a URL), directories made as needed; returns `dst`."""
    if not is_remote(dst):
        shutil.copytree(src, dst, dirs_exist_ok=True)
        return dst
    fs, root = filesystem(dst)
    for here, _, files in os.walk(src):
        rel = os.path.relpath(here, src)
        target = root if rel == "." else "/".join(
            [root.rstrip("/"), *rel.split(os.sep)])
        fs.makedirs(target, exist_ok=True)
        for name in sorted(files):
            fs.put_file(os.path.join(here, name), f"{target}/{name}")
    return dst
