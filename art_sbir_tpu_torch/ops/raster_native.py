"""ctypes binding of the native C++ host rasterizer (``native/raster.cpp``).

Counterpart of ``art_sbir_tpu/ops/raster_native.py``, with the same
``rasterize_batch_native`` contract. The source is compiled unchanged with
g++ at first use into ``art_sbir_tpu_torch/_build/`` (never into
``native/``), keyed by a hash of the source
(:func:`art_sbir_tpu_torch.data.native_loader.build_library`). It draws the
reference's pipeline on the host, sketch by sketch, and is the oracle the
card's rasterizer (:mod:`art_sbir_tpu_torch.ops.rasterize`) is held to.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from art_sbir_tpu_torch.data.native_loader import (NativeUnavailable,
                                                   build_library)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "raster.cpp"
SIDE = 256

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build_library(SOURCE, "raster")))
        except OSError as e:
            raise NativeUnavailable(f"cannot load libraster: {e}") from e
        lib.rasterize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        lib.rasterize_batch.restype = None
        _lib = lib
        return lib


def rasterize_batch_native(strokes) -> np.ndarray:
    """(B, T, 5|3) float strokes -> (B, 256, 256) float32 canvases, 0 or
    255, the reference pipeline's on the host."""
    lib = load()
    s = np.ascontiguousarray(strokes, np.float32)
    b, t, dims = s.shape
    out = np.empty((b, SIDE, SIDE), np.float32)
    lib.rasterize_batch(s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        b, t, dims,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
