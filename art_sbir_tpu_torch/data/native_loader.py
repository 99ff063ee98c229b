"""ctypes binding for the native C++ image pipeline (``native/imgpipe.cpp``):
threaded JPEG/PNG decode, Pillow-exact bicubic resize and center crop.

Counterpart of ``art_sbir_tpu/data/native_loader.py`` with the same
``decode_batch`` / ``decode_batch_mem`` contract. The source is compiled
unchanged with ``g++ ... -ljpeg -lpng -lpthread`` at first use into
``art_sbir_tpu_torch/_build/`` (never into ``native/``), keyed by a hash
of the source. Output is bit-identical to
:func:`art_sbir_tpu_torch.data.loader.decode_image` (the same system
libjpeg-turbo and libpng, Pillow's fixed-point resampling); images the
native decoder does not support (CMYK, 16-bit, exotic containers,
corrupt files) are reported per image, and the caller decodes those with
PIL. This is host code, not a device kernel: one call fans a batch over a
C++ thread pool without the interpreter lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "imgpipe.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-Wall", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_MODES = {"square": 0, "shortest_crop": 1}
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def build_library(source: Path, stem: str, libs=()) -> Path:
    """Compile ``source`` with g++ into ``_build/lib<stem>_<hash>.so``
    (once per source and flags) and return the library's path. The
    library is written under a temporary name and renamed, so that two
    processes building at once never load a half-written file."""
    if not source.is_file():
        raise NativeUnavailable(f"missing {source}")
    flags = (*CXX_FLAGS, *libs)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}_{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(source), *libs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeUnavailable(f"g++ not found: {e}") from e
    except subprocess.CalledProcessError as e:
        raise NativeUnavailable(f"g++ build failed:\n{e.stderr}") from e
    os.replace(tmp, out)
    return out


def build() -> Path:
    """Compile ``native/imgpipe.cpp`` into ``_build/`` and return the
    library's path."""
    return build_library(SOURCE, "imgpipe", LIBS)


def load() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except OSError as e:
            raise NativeUnavailable(f"cannot load libimgpipe: {e}") from e
        lib.decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)]
        lib.decode_resize_batch.restype = None
        lib.decode_resize_batch_mem.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)]
        lib.decode_resize_batch_mem.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def default_threads() -> int:
    return max(1, os.cpu_count() or 1)


def _decode(fn, args, n: int, size: int, resize_mode: str, grayscale: bool,
            n_threads: Optional[int]) -> Tuple[np.ndarray, List[int]]:
    if resize_mode not in _MODES:
        raise ValueError(f"unknown resize_mode {resize_mode}")
    out = np.empty((n, size, size, 1 if grayscale else 3), np.uint8)
    status = np.zeros(n, np.int32)
    if n == 0:
        return out, []
    fn(*args, n, size, _MODES[resize_mode], int(grayscale),
       n_threads or default_threads(),
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
       status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, np.nonzero(status)[0].tolist()


def decode_batch(paths: Sequence[Path | str], size: int,
                 resize_mode: str = "square", grayscale: bool = False,
                 n_threads: Optional[int] = None
                 ) -> Tuple[np.ndarray, List[int]]:
    """Decode and resize ``paths`` into one (N, size, size, C) uint8 array.

    Returns ``(batch, failed)``: ``failed`` lists the indices the native
    pipeline could not handle (their rows are undefined; decode those with
    PIL). ctypes releases the interpreter lock for the call."""
    lib = load()
    arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
    return _decode(lib.decode_resize_batch, (arr,), len(paths), size,
                   resize_mode, grayscale, n_threads)


def decode_batch_mem(buffers: Sequence[bytes], size: int,
                     resize_mode: str = "square", grayscale: bool = False,
                     n_threads: Optional[int] = None
                     ) -> Tuple[np.ndarray, List[int]]:
    """:func:`decode_batch` over in-memory byte streams (HTTP request
    bodies); the same status contract."""
    lib = load()
    n = len(buffers)
    # c_char_p borrows a pointer into each bytes object (kept alive by
    # ``buffers`` for the call); lengths ride separately, so embedded NULs
    # are fine
    bufs = (ctypes.c_char_p * n)(*buffers)
    lens = (ctypes.c_longlong * n)(*[len(b) for b in buffers])
    return _decode(lib.decode_resize_batch_mem, (bufs, lens), n, size,
                   resize_mode, grayscale, n_threads)
