"""``art_sbir_tpu_torch/core/jax_random.py`` against ``jax.random`` on the
CPU (jax's default ``threefry2x32``, partitionable).

Keys, ``split``, ``fold_in``, random bits and uniforms must be equal bit
for bit. ``normal`` and ``truncated_normal`` go through the inverse error
function, which XLA computes by Giles' float32 polynomial over its own
approximate ``log1p``; the port's evaluates the same polynomial over a
``log1p`` taken in float64. The largest distance measured on 10^7
values: 2 float32 ulp for ``erfinv`` (``ERFINV_ULP``), 3 for ``normal``
and ``truncated_normal`` (``DRAW_ULP``) after the multiply by sqrt(2).
Shapes include odd sizes and one over 2^16 words; seeds include a
negative one and int32's largest. The draws run in the host library
(``csrc/jax_random_host.cpp``), held here to the module's numpy form bit
for bit.
"""

import jax
import numpy as np
import pytest
import torch

from art_sbir_tpu_torch.core import jax_random as jr
from tests.torch_threads import two_torch_threads  # noqa: F401

ERFINV_ULP = 2
DRAW_ULP = 3
SEEDS = (0, 1, 7, -1, 2 ** 31 - 1)
SHAPES = ((7,), (3, 5, 2), (70001,))


ulp_distance = jr.ulp_distance


def test_ulp_distance_counts_float32_steps():
    one = np.float32(1.0)
    up = np.nextafter(one, np.float32(2))
    assert jr.ulp_distance(one, up) == 1
    tiny = np.float32(1e-45)  # the smallest subnormal
    assert jr.ulp_distance(-tiny, tiny) == 2
    assert jr.ulp_distance(np.float32(-0.0), np.float32(0.0)) == 0


def _words(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_are_exact(seed):
    jk, k = jax.random.key(seed), jr.key(seed)
    np.testing.assert_array_equal(_words(jk), k)
    for data in (0, 1, 12345, 2 ** 32 - 1):
        np.testing.assert_array_equal(_words(jax.random.fold_in(jk, data)),
                                      jr.fold_in(k, data))
    for num in (1, 2, 5):
        np.testing.assert_array_equal(_words(jax.random.split(jk, num)),
                                      jr.split(k, num))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_are_exact(seed, shape):
    jk, k = jax.random.key(seed), jr.key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.bits(jk, shape)),
                                  jr.random_bits(k, shape))
    for lo, hi in ((0.0, 1.0), (-0.3, 0.9), (-0.9544997, 0.9544997)):
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                             maxval=hi))
        np.testing.assert_array_equal(want.view(np.uint32),
                                      jr.uniform(k, shape, lo, hi)
                                      .view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_and_truncated_normal_within_bound(seed, shape):
    jk, k = jax.random.key(seed), jr.key(seed)
    got = jr.normal(k, shape)
    assert got.dtype == np.float32 and got.shape == shape
    assert ulp_distance(np.asarray(jax.random.normal(jk, shape)),
                        got).max() <= DRAW_ULP
    got = jr.truncated_normal(k, -2.0, 2.0, shape)
    want = np.asarray(jax.random.truncated_normal(jk, -2.0, 2.0, shape))
    assert ulp_distance(want, got).max() <= DRAW_ULP
    # the clip to the open interval holds exactly
    assert np.abs(got).max() < 2.0


def test_erfinv_within_bound_on_ten_million_values():
    """The measurement behind ``ERFINV_ULP`` (and the module docstring's):
    10^7 uniforms over (-1, 1), and the draws' own range, against
    ``jax.lax.erf_inv``."""
    x = np.random.default_rng(0).uniform(-1, 1, 10 ** 7).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    d = ulp_distance(want, jr.erfinv(x))
    assert d.max() <= ERFINV_ULP
    assert d.mean() < 0.02  # about 1% of values differ, by one ulp
    edges = np.array([-1.0, 1.0, 0.0], np.float32)
    np.testing.assert_array_equal(jr.erfinv(edges),
                                  np.asarray(jax.lax.erf_inv(edges)))


def test_draws_of_ten_million_within_bound():
    """The measurement behind ``DRAW_ULP``."""
    jk, k = jax.random.key(3), jr.key(3)
    n = 10 ** 7
    want = np.asarray(jax.jit(lambda kk: jax.random.truncated_normal(
        kk, -2.0, 2.0, (n,)))(jk))
    assert ulp_distance(want, jr.truncated_normal(k, -2, 2, (n,))).max() \
        <= DRAW_ULP
    want = np.asarray(jax.jit(lambda kk: jax.random.normal(kk, (n,)))(jk))
    assert ulp_distance(want, jr.normal(k, (n,))).max() <= DRAW_ULP


@pytest.mark.parametrize("seed", [0, -1])
def test_host_library_draws_the_numpy_forms_values(seed):
    """``csrc/jax_random_host.cpp`` (what ``normal`` and
    ``truncated_normal`` run where g++ builds it) against the numpy form,
    bit for bit, over 4,000,003 words: the truncated normal's range, the
    normal's, and a range that reaches +-1 (erfinv's infinities)."""
    assert jr.host_library() is not None  # the tests' CPU has g++
    k = jr.key(seed)
    f32 = np.float32
    for a, b, lo, hi in (
            (f32(-0.9544997), f32(0.9544997), np.nextafter(f32(-2), f32(0)),
             np.nextafter(f32(2), f32(0))),
            (np.nextafter(f32(-1), f32(0)), f32(1), f32(-np.inf),
             f32(np.inf)),
            (f32(-1), f32(1), f32(-np.inf), f32(np.inf))):
        got = jr.inverse_cdf(k, (4_000_003,), a, b, lo, hi)
        want = jr.inverse_cdf_numpy(k, (4_000_003,), a, b, lo, hi)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_seed_outside_int32_is_refused():
    with pytest.raises(ValueError, match="int32"):
        jr.key(2 ** 31)
