"""The port's exact retrieval route against ``art_sbir_tpu.ops.distance``.

Same numpy inputs through both packages (JAX on the CPU at 'highest'
precision, the port on the CPU in IEEE float32). Indices and ranks must
match exactly; values at rtol 1e-6 (the cross term comes from two BLAS
libraries that sum in different orders, a few float32 ulps apart)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.ops import distance as J
from art_sbir_tpu_torch.ops import distance as T
from tests.torch_threads import two_torch_threads  # noqa: F401


RTOL, ATOL = 1e-6, 1e-6


def _pair(rng, q, n, d=64):
    return (rng.standard_normal((q, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("fn,kw", [
    ("pairwise_sq_l2", {}), ("pairwise_sq_l2", {"eps": 1e-6}),
    ("pairwise_l2", {}), ("pairwise_cosine", {}),
])
def test_pairwise_matches_jax(rng, fn, kw):
    q, g = _pair(rng, 13, 301)
    want = _np(getattr(J, fn)(jnp.asarray(q), jnp.asarray(g), **kw))
    got = _np(getattr(T, fn)(torch.from_numpy(q), torch.from_numpy(g), **kw))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_pairwise_distance_default_precision(rng, metric):
    """'default' rounds the cross-term operands to bf16 (the JAX CPU
    backend computes in f32 whatever the precision, so the port is held
    against the JAX function on bf16-rounded copies of the inputs)."""
    q, g = _pair(rng, 5, 77)
    qb = np.asarray(torch.from_numpy(q).bfloat16().float())
    gb = np.asarray(torch.from_numpy(g).bfloat16().float())
    got = _np(T.pairwise_distance(torch.from_numpy(q), torch.from_numpy(g),
                                  metric, precision="default"))
    if metric == "cosine":  # norms come from the unrounded rows
        nq = np.linalg.norm(q, axis=1, keepdims=True)
        ng = np.linalg.norm(g, axis=1)
        want = 1.0 - (qb @ gb.T) / np.maximum(nq * ng, 1e-8)
    else:
        want = _np(J.pairwise_l2(jnp.asarray(q), jnp.asarray(g))) ** 2
        want = want + 2.0 * (q @ g.T - qb @ gb.T)
        want = np.sqrt(np.maximum(want, 0.0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_rowwise_distances_match_jax(rng):
    a, b = _pair(rng, 9, 9)
    for name in ("euclidean_distance", "cosine_distance"):
        want = _np(getattr(J, name)(jnp.asarray(a), jnp.asarray(b)))
        got = _np(getattr(T, name)(torch.from_numpy(a), torch.from_numpy(b)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("masked", [False, True])
def test_retrieve_matches_jax(rng, metric, masked):
    q, g = _pair(rng, 21, 517)
    pos = rng.integers(0, 517, 21).astype(np.int32)
    valid = rng.random(517) > 0.3 if masked else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    r0, v0, i0 = J.retrieve(jnp.asarray(q), jnp.asarray(g), jnp.asarray(pos),
                            k=10, metric=metric, valid=jv)
    r1, v1, i1 = T.retrieve(torch.from_numpy(q), torch.from_numpy(g),
                            torch.from_numpy(pos), k=10, metric=metric,
                            valid=tv)
    np.testing.assert_array_equal(_np(i1), _np(i0))
    np.testing.assert_array_equal(_np(r1), _np(r0))
    np.testing.assert_allclose(_np(v1), _np(v0), rtol=RTOL, atol=ATOL)
    assert i1.dtype == torch.int32 and r1.dtype == torch.int32


def test_top_k_masked_rows_are_inf_and_dropped(rng):
    """Masked rows become +inf; with fewer live rows than k the tail of
    the top-k is +inf, as in the JAX package (and the engine's _result
    drops them by isfinite)."""
    dist = rng.random((3, 12)).astype(np.float32)
    valid = np.zeros(12, bool)
    valid[[2, 5, 9]] = True
    v0, i0 = J.top_k(jnp.asarray(dist), 5, jnp.asarray(valid))
    v1, i1 = T.top_k(torch.from_numpy(dist), 5, torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(v1), _np(v0))
    assert np.isinf(_np(v1)[:, 3:]).all()
    np.testing.assert_array_equal(np.sort(_np(i1)[:, :3], 1),
                                  np.tile([2, 5, 9], (3, 1)))
    np.testing.assert_array_equal(_np(i1)[:, :3], _np(i0)[:, :3])


def test_top_k_clamps_k_to_gallery(rng):
    dist = rng.random((2, 4)).astype(np.float32)
    v, i = T.top_k(torch.from_numpy(dist), 10)
    assert tuple(v.shape) == (2, 4)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_manufactured_ties_match_jax(rng, metric):
    """Duplicated gallery rows tie exactly; ranks and top-k order them by
    gallery index, as the JAX package's stable order does."""
    d = 16
    base = rng.standard_normal((40, d)).astype(np.float32)
    g = np.concatenate([base, base[:20], base[:5]], axis=0)
    q = base[[3, 7, 11, 2]] + 0.01 * rng.standard_normal((4, d)).astype(
        np.float32)
    pos = np.array([3, 47, 51, 62], np.int32)  # 47, 51, 62 are duplicates
    r0, v0, i0 = J.retrieve(jnp.asarray(q), jnp.asarray(g), jnp.asarray(pos),
                            k=10, metric=metric)
    r1, v1, i1 = T.retrieve(torch.from_numpy(q), torch.from_numpy(g),
                            torch.from_numpy(pos), k=10, metric=metric)
    np.testing.assert_array_equal(_np(i1), _np(i0))
    np.testing.assert_array_equal(_np(r1), _np(r0))
    # row 3 and its copy at 43 are the two nearest, the smaller index first
    assert list(_np(i1)[0, :2]) == [3, 43]
    assert _np(v1)[0, 0] == _np(v1)[0, 1]


def test_retrieve_chunked_matches_jax(rng):
    q, g = _pair(rng, 11, 200)
    pos = rng.integers(0, 200, 11).astype(np.int32)
    outs0 = J.retrieve_chunked(jnp.asarray(q), jnp.asarray(g),
                               jnp.asarray(pos), k=7, chunk=4)
    outs1 = T.retrieve_chunked(torch.from_numpy(q), torch.from_numpy(g),
                               torch.from_numpy(pos), k=7, chunk=4)
    np.testing.assert_array_equal(_np(outs1[0]), _np(outs0[0]))
    np.testing.assert_array_equal(_np(outs1[2]), _np(outs0[2]))
    np.testing.assert_allclose(_np(outs1[1]), _np(outs0[1]), rtol=RTOL,
                               atol=ATOL)


def test_unknown_metric_and_precision_raise(rng):
    q, g = (torch.from_numpy(a) for a in _pair(rng, 2, 3))
    with pytest.raises(ValueError, match="metric"):
        T.pairwise_distance(q, g, "manhattan")
    with pytest.raises(ValueError, match="precision"):
        T.pairwise_l2(q, g, precision="tf32")
