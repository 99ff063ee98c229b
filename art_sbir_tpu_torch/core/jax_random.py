"""A numpy replica of ``jax.random``'s default generator, without JAX.

The port draws the JAX package's fresh init of the triplet encoder
(``models/flax_draw.py``) from the same seed as the JAX package does. That
init is a pure function of the seed: JAX's ``threefry2x32`` generator in
its partitionable layout (``jax_threefry_partitionable``, the default
since jax 0.5), and ``jax.random``'s ``uniform``, ``normal`` and
``truncated_normal`` on top of it. Here each is computed in numpy
``uint32`` and ``float32`` arithmetic, after jax 0.9's sources:

* ``threefry2x32``: Salmon et al., "Parallel random numbers: as easy as
  1, 2, 3" (SC 2011), 20 rounds in five groups of four, as
  ``jax/_src/prng.py::_threefry2x32_lowering`` runs them;
* :func:`key`, :func:`fold_in`, :func:`split` and :func:`random_bits`:
  ``prng.py::threefry_seed``, ``threefry_fold_in``,
  ``_threefry_split_foldlike`` and ``_threefry_random_bits_partitionable``
  (a flat row-major index ``i`` is hashed as the pair ``(i >> 32, i &
  0xFFFFFFFF)``; 32-bit words are the two halves XORed);
* :func:`uniform`, :func:`normal` and :func:`truncated_normal`:
  ``jax/_src/random.py``'s ``_uniform`` (23 random mantissa bits under a
  unit exponent), ``_normal_real`` and ``_truncated_normal`` (the inverse
  CDF, then the clip to the ``nextafter`` bounds).

Keys, bits and uniforms equal ``jax.random``'s bit for bit. ``normal``
and ``truncated_normal`` go through the inverse error function, which
XLA computes in float32 by Giles' single-precision polynomial
("Approximating the erfinv function", GPU Computing Gems, 2010) over its
own approximate ``log1p``. :func:`erfinv` evaluates the same polynomial
on a ``log1p`` taken in float64, so it lies within 2 float32 ulp of
XLA's CPU ``erf_inv``, and ``normal`` and ``truncated_normal`` within 3
of JAX's (``tests/test_torch_jax_random.py`` measures both on 10^7
values). Every operation here is IEEE float32 or float64 arithmetic on
the host (``log1p`` in float64, rounded once to float32), so a draw does
not depend on the device; ``scripts/probe_init_draw.py`` hashes the
encoder's to compare hosts. ``normal`` and ``truncated_normal`` run in a
small C++ library (``csrc/jax_random_host.cpp``, built with g++ at first
use) where it builds: the same arithmetic element for element, without
the interpreter lock, so threads draw tensors side by side; the numpy
form is the reference it is held to and the fallback without g++.
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_CHUNK = 1 << 18  # words hashed at a time: the block stays in the cache

# Giles' coefficients, highest power first, for w = -log1p(-x^2) below 5
# (in w - 2.5) and from 5 (in sqrt(w) - 3): XLA's ``ErfInv32``
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
SQRT2 = np.float32(math.sqrt(2.0))
HOST_SOURCE = (Path(__file__).resolve().parents[1] / "csrc"
               / "jax_random_host.cpp")

_lock = threading.Lock()
_host: Optional[ctypes.CDLL] = None
_host_tried = False


def _hash(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray) -> None:
    """``threefry2x32`` of the key ``(k0, k1)`` on the words ``(x0, x1)``,
    in place."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 += np.uint32(ks[0])
    x1 += np.uint32(ks[1])
    tmp = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=tmp)
            x1 >>= np.uint32(32 - r)
            x1 |= tmp
            x1 ^= x0
        x0 += np.uint32(ks[(i + 1) % 3])
        x1 += np.uint32((ks[(i + 2) % 3] + i + 1) & MASK32)


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The hash of the word pairs ``(x0[i], x1[i])`` under ``key``."""
    k0, k1 = (int(k) for k in key)
    y0 = np.array(x0, np.uint32)
    y1 = np.array(x1, np.uint32)
    _hash(k0, k1, y0, y1)
    return y0, y1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s words: ``(0, seed mod 2^32)`` for a seed
    in int32's range (a Python int becomes JAX's default int32)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside int32's range")
    return np.array([0, seed & MASK32], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``: the hash of ``(0, data)``."""
    y0, y1 = threefry2x32(k, [0], [data & MASK32])
    return np.array([y0[0], y1[0]], np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``, (num, 2): key ``i`` is the hash of
    ``(0, i)``."""
    y0, y1 = threefry2x32(k, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=1)


def _bits_block(k0: int, k1: int, start: int, stop: int) -> np.ndarray:
    x0 = np.zeros(stop - start, np.uint32)
    x1 = np.arange(start, stop, dtype=np.uint32)
    _hash(k0, k1, x0, x1)
    x0 ^= x1
    return x0


def _blocks(k: np.ndarray, shape: Sequence[int], dtype, fn) -> np.ndarray:
    """``fn`` of each block of the random words of ``shape``, in
    ``_CHUNK`` words at a time (each block's work stays in the cache)."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError("over 2^32 words need the high count word")
    k0, k1 = (int(w) for w in k)
    out = np.empty(n, dtype)
    for start in range(0, n, _CHUNK):
        stop = min(start + _CHUNK, n)
        out[start:stop] = fn(_bits_block(k0, k1, start, stop))
    return out.reshape(shape)


def random_bits(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(k, shape)`` (uint32): word ``i`` of the flat
    row-major array is the XOR of the hash of ``(0, i)``'s two words."""
    return _blocks(k, shape, np.uint32, lambda bits: bits)


def _to_range(bits: np.ndarray, lo: np.float32, hi: np.float32
              ) -> np.ndarray:
    """``_uniform``'s float32 map of random words to [lo, hi)."""
    bits >>= np.uint32(9)
    bits |= np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    # the product is exact in float64, then one rounding of the sum to
    # float32: the fused multiply-add XLA emits
    scaled = (floats * np.float64(hi - lo) + lo).astype(np.float32)
    return np.maximum(lo, scaled)


def uniform(k: np.ndarray, shape: Sequence[int], minval=0.0, maxval=1.0
            ) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits give a
    value in [1, 2); less 1, scaled to [minval, maxval), no lower than
    minval."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return _blocks(k, shape, np.float32, lambda b: _to_range(b, lo, hi))


def _poly(w: np.ndarray, coefs: Sequence[float]) -> np.ndarray:
    """Horner's rule in float32, each step one rounding of ``p * w + c``
    (the product is exact in float64): the fused multiply-add XLA
    emits."""
    w64 = w.astype(np.float64)
    p = np.full(w.shape, coefs[0], np.float32)
    acc = np.empty_like(w64)
    for c in coefs[1:]:
        np.multiply(p, w64, out=acc)
        acc += np.float32(c)
        p[...] = acc
    return p


def _erfinv_block(x: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):  # log1p(-1) at x = +-1
        w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    small = w < np.float32(5)
    if small.all():
        p = _poly(w - np.float32(2.5), _ERFINV_SMALL)
    else:
        p = np.empty_like(w)
        p[small] = _poly(w[small] - np.float32(2.5), _ERFINV_SMALL)
        large = ~small
        p[large] = _poly(np.sqrt(w[large]) - np.float32(3), _ERFINV_LARGE)
    out = p * x
    edge = np.abs(x) == 1
    if edge.any():
        out[edge] = x[edge] * np.inf
    return out


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function by XLA's algorithm (Giles'
    polynomial, ``w = -log1p(-x^2)``, one branch below 5 and one from
    5), within 2 ulp of XLA's CPU ``erf_inv`` on (-1, 1)."""
    x = np.ascontiguousarray(x, np.float32)
    flat = x.reshape(-1)
    out = np.empty_like(flat)
    for start in range(0, flat.size, _CHUNK):
        out[start:start + _CHUNK] = _erfinv_block(flat[start:start + _CHUNK])
    return out.reshape(x.shape)


def host_library() -> Optional[ctypes.CDLL]:
    """``csrc/jax_random_host.cpp`` (the draws below in C++, element for
    element this module's arithmetic), built with g++ at first use; None
    where it cannot be built, and the numpy form draws instead."""
    global _host, _host_tried
    from art_sbir_tpu_torch.data.native_loader import (NativeUnavailable,
                                                       build_library)

    with _lock:
        if not _host_tried:
            _host_tried = True
            try:
                lib = ctypes.CDLL(str(build_library(HOST_SOURCE,
                                                    "jax_random")))
            except (NativeUnavailable, OSError):
                return None
            f32 = ctypes.c_float
            lib.jr_inverse_cdf.argtypes = [
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
                ctypes.c_int64, f32, f32, f32, f32, f32,
                ctypes.POINTER(f32)]
            lib.jr_inverse_cdf.restype = None
            _host = lib
        return _host


def inverse_cdf_numpy(k: np.ndarray, shape: Sequence[int], a, b, lo, hi,
                      scale=SQRT2) -> np.ndarray:
    """``scale * erfinv(u)`` (``scale`` sqrt(2)), u uniform in [a, b),
    clipped to [lo, hi], in numpy: the reference form of
    :func:`inverse_cdf`."""
    scale = np.float32(scale)
    return _blocks(k, shape, np.float32, lambda bits: np.clip(
        scale * _erfinv_block(_to_range(bits, a, b)), lo, hi))


def inverse_cdf(k: np.ndarray, shape: Sequence[int], a, b, lo, hi,
                scale=SQRT2) -> np.ndarray:
    """:func:`inverse_cdf_numpy`'s values, by the host library where it
    builds (it releases the interpreter lock, so threads draw side by
    side)."""
    lib = host_library()
    if lib is None:
        return inverse_cdf_numpy(k, shape, a, b, lo, hi, scale)
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError("over 2^32 words need the high count word")
    out = np.empty(n, np.float32)
    lib.jr_inverse_cdf(int(k[0]), int(k[1]), 0, n, a, b, lo, hi,
                       np.float32(scale),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out.reshape(shape)


def normal(k: np.ndarray, shape: Sequence[int], scale=None) -> np.ndarray:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)``, u uniform
    in (-1, 1). With ``scale``, ``normal * scale`` as XLA compiles it: the
    two constants folded into one, ``erfinv(u) * (sqrt(2) * scale)`` (the
    product of float32s), a rounding fewer."""
    return inverse_cdf(k, shape, np.nextafter(np.float32(-1), np.float32(0)),
                       np.float32(1), np.float32(-np.inf),
                       np.float32(np.inf),
                       SQRT2 if scale is None else SQRT2 * np.float32(scale))


def _erf32(x: np.float32) -> np.float32:
    return np.float32(math.erf(float(x)))


def truncated_normal(k: np.ndarray, lower: float, upper: float,
                     shape: Sequence[int]) -> np.ndarray:
    """``jax.random.truncated_normal`` in float32: the inverse CDF of a
    uniform over ``(erf(lower / sqrt 2), erf(upper / sqrt 2))``, clipped
    to the open interval ``(lower, upper)``."""
    lower, upper = np.float32(lower), np.float32(upper)
    return inverse_cdf(k, shape, _erf32(lower / SQRT2), _erf32(upper / SQRT2),
                       np.nextafter(lower, np.float32(np.inf)),
                       np.nextafter(upper, np.float32(-np.inf)))


def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """How many float32 steps apart ``a`` and ``b`` lie, elementwise (the
    values as integers on one line, where neighbours differ by 1)."""
    def line(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(line(a) - line(b))
