"""The port's int8 retrieval (``ops/quant.py``) against the JAX package's,
on the CPU, with inputs from a numpy seed.

Tolerances, from a run of both packages on a 20,000 x 1024 gallery:

* euclidean quantization: codes and scales bit-identical; ``sq_norm``
  within rtol 1e-6 (the two libraries sum a row in different orders, and
  it differed by ulps in most rows);
* cosine quantization: the rows are L2-normalized first, and the norm
  differs by an ulp between the libraries, so a code may move by 1 where
  a value sits on a rounding boundary: at most 1, in at most 1e-5 of the
  elements (17 of 20.48 M observed); scales within rtol 1e-6;
* the plain int8 scan fed the JAX package's own quantized arrays: the
  same integers and the same float32 op order, so the candidate indices
  are bit-identical;
* retrieval on separated data: indices identical, values (row-wise sums
  in each library's order) within rtol 1e-6; cosine values also within
  an absolute 1e-6, since ``1 - sim`` of a near match cancels against 1
  and keeps the error of ``sim``, about an ulp of 1.0 (1.2e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.ops import quant as jq
from art_sbir_tpu_torch.ops import quant as pq
from art_sbir_tpu_torch.ops import quant_fused
from art_sbir_tpu_torch.parallel.mesh import MeshSpec
from tests.torch_threads import two_torch_threads  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_values(v1, v0, metric):
    np.testing.assert_allclose(v1, v0, rtol=1e-6,
                               atol=1e-6 if metric == "cosine" else 0.0)


def _separated(rng, n, d, q, off=0, noise=0.05):
    gal = rng.standard_normal((n, d)).astype(np.float32)
    qs = gal[off:off + q] + noise * rng.standard_normal((q, d)).astype(
        np.float32)
    return gal, qs


@pytest.fixture(scope="module")
def big_gallery():
    return np.random.default_rng(7).standard_normal(
        (20_000, 1024)).astype(np.float32)


def test_quantize_gallery_euclidean_matches_jax(big_gallery):
    want = jq.quantize_gallery(jnp.asarray(big_gallery), "euclidean")
    got = pq.quantize_gallery(torch.from_numpy(big_gallery), "euclidean")
    assert isinstance(got, pq.QuantGallery) and got.metric == "euclidean"
    assert got.q8.dtype == torch.int8 and tuple(got.q8.shape) == (20_000,
                                                                  1024)
    np.testing.assert_array_equal(got.q8.numpy(), np.asarray(want.q8))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_allclose(got.sq_norm.numpy(), np.asarray(want.sq_norm),
                               rtol=1e-6)


def test_quantize_gallery_cosine_matches_jax(big_gallery):
    want = jq.quantize_gallery(jnp.asarray(big_gallery), "cosine")
    got = pq.quantize_gallery(torch.from_numpy(big_gallery), "cosine")
    diff = np.abs(got.q8.numpy().astype(np.int32)
                  - np.asarray(want.q8).astype(np.int32))
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 1e-5 * diff.size
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-6)
    assert not got.sq_norm.numpy().any()


def test_round_half_to_even_and_clip():
    rows = torch.tensor([[127.0, 0.5, 1.5, -2.5, -127.0, 63.5]])
    q8, scale = pq._symmetric_quantize(rows)
    assert float(scale[0]) == 1.0
    assert q8.tolist() == [[127, 0, 2, -2, -127, 64]]
    want, _ = jq._symmetric_quantize(jnp.asarray(rows.numpy()))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(want))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_quant_core_candidates_match_jax(rng, metric):
    """With k = r the reranked output holds the whole candidate set, so
    the candidate indices of both packages' ``_quant_core`` are compared
    directly, fed the JAX package's own quantized gallery, on flat random
    data where many scores lie close to the r-th."""
    gal = rng.standard_normal((3000, 128)).astype(np.float32)
    qs = rng.standard_normal((16, 128)).astype(np.float32)
    qg = jq.quantize_gallery(jnp.asarray(gal), metric)
    r = 40
    v0, i0 = jq._quant_core(jnp.asarray(qs), qg.q8, qg.scale, qg.sq_norm,
                            jnp.asarray(gal), metric=metric, k=r, r=r)
    v1, i1 = pq._quant_core(torch.from_numpy(qs), _t(qg.q8), _t(qg.scale),
                            _t(qg.sq_norm), torch.from_numpy(gal),
                            metric=metric, k=r, r=r)
    np.testing.assert_array_equal(np.sort(i1.numpy(), 1),
                                  np.sort(np.asarray(i0), 1))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))
    _assert_values(v1.numpy(), np.asarray(v0), metric)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_retrieve_quantized_matches_jax(rng, metric):
    gal, qs = _separated(rng, 512, 128, 32)
    v0, i0 = jq.retrieve_quantized(
        jnp.asarray(qs), jq.quantize_gallery(jnp.asarray(gal), metric),
        jnp.asarray(gal), k=10)
    v1, i1 = pq.retrieve_quantized(
        torch.from_numpy(qs), pq.quantize_gallery(torch.from_numpy(gal),
                                                  metric),
        torch.from_numpy(gal), k=10)
    assert i1.dtype == torch.int32 and tuple(i1.shape) == (32, 10)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))
    _assert_values(v1.numpy(), np.asarray(v0), metric)
    assert (i1.numpy()[:, 0] == np.arange(32)).all()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_retrieve_quantized_chunked_matches_jax(rng, metric):
    gal, qs = _separated(rng, 256, 64, 40)
    v0, i0 = jq.retrieve_quantized_chunked(
        jnp.asarray(qs), jq.quantize_gallery(jnp.asarray(gal), metric),
        jnp.asarray(gal), k=5, chunk=16)
    qg = pq.quantize_gallery(torch.from_numpy(gal), metric)
    v1, i1 = pq.retrieve_quantized_chunked(torch.from_numpy(qs), qg,
                                           torch.from_numpy(gal), k=5,
                                           chunk=16)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))
    _assert_values(v1.numpy(), np.asarray(v0), metric)
    ve, ie = pq.retrieve_quantized_chunked(torch.from_numpy(qs[:0]), qg,
                                           torch.from_numpy(gal), k=5)
    assert tuple(ve.shape) == (0, 5) and tuple(ie.shape) == (0, 5)
    assert ie.dtype == torch.int32


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_bf16_rerank_rows_match_jax(rng, metric):
    """A bf16-resident rerank gallery: both packages gather the bf16 rows
    and widen them to float32 after, so they rerank the same values."""
    gal, qs = _separated(rng, 300, 64, 12, off=20)
    g16 = torch.from_numpy(gal).to(torch.bfloat16)
    v0, i0 = jq.retrieve_quantized(
        jnp.asarray(qs), jq.quantize_gallery(jnp.asarray(gal), metric),
        jnp.asarray(gal).astype(jnp.bfloat16), k=6, rerank_factor=4)
    v1, i1 = pq.retrieve_quantized(
        torch.from_numpy(qs), pq.quantize_gallery(torch.from_numpy(gal),
                                                  metric), g16, k=6,
        rerank_factor=4)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))
    _assert_values(v1.numpy(), np.asarray(v0), metric)


def test_k_clamps_to_the_gallery(rng):
    gal = rng.standard_normal((8, 16)).astype(np.float32)
    qg = pq.quantize_gallery(torch.from_numpy(gal))
    v, i = pq.retrieve_quantized(torch.from_numpy(gal[:3]), qg,
                                 torch.from_numpy(gal), k=50)
    assert tuple(v.shape) == (3, 8) and tuple(i.shape) == (3, 8)
    assert i[:, 0].tolist() == [0, 1, 2]


def test_topk_overlap_matches_jax():
    a = np.array([[1, 2, 3], [4, 5, 6]])
    b = np.array([[1, 2, 9], [7, 8, 9]])
    assert pq.topk_overlap(a, b) == pytest.approx((2 / 3 + 0) / 2)
    assert pq.topk_overlap(torch.from_numpy(a), b) == jq.topk_overlap(a, b)


def test_guards(rng):
    gal = rng.standard_normal((16, 32)).astype(np.float32)
    with pytest.raises(ValueError, match="unknown metric"):
        pq.quantize_gallery(torch.from_numpy(gal), metric="l2")
    # the sharded route refuses a ragged gallery (16 rows on 3 shards)
    g16 = torch.from_numpy(gal)
    mesh = MeshSpec(3).build([torch.device("cpu")] * 3)
    with pytest.raises(ValueError, match="divisible by"):
        pq.retrieve_quantized_sharded(g16[:2], pq.quantize_gallery(g16), g16,
                                      mesh)
    # off the CPU the cross term is summed in float32 slices of at most
    # F32_EXACT_DIM columns and added in int32, so a wider D is served
    wide = torch.empty((2, quant_fused.F32_EXACT_DIM + 1), dtype=torch.int8,
                       device="meta")
    assert tuple(quant_fused.int8_cross(wide, wide).shape) == (2, 2)
    ok = torch.empty((2, quant_fused.F32_EXACT_DIM), dtype=torch.int8,
                     device="meta")
    assert tuple(quant_fused.int8_cross(ok, ok).shape) == (2, 2)


@pytest.mark.parametrize("width", [4, 5, 37, 64])
def test_sliced_int8_cross_is_the_int32_product(rng, width):
    """The card's slicing at a small slice width, run here: equal bit for
    bit to the int32 product, extreme codes included."""
    q8 = rng.integers(-127, 128, size=(5, 37)).astype(np.int8)
    g8 = rng.integers(-127, 128, size=(11, 37)).astype(np.int8)
    q8[0], g8[0] = 127, -127
    want = q8.astype(np.int32) @ g8.astype(np.int32).T
    got = quant_fused.sliced_int8_cross(_t(q8), _t(g8), width=width)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_cross_off_the_cpu_at_2048_columns():
    """A device other than the CPU takes the sliced route; at D = 2,048
    it gives the (Q, N) float32 shape."""
    q8 = torch.empty((3, 2048), dtype=torch.int8, device="meta")
    g8 = torch.empty((7, 2048), dtype=torch.int8, device="meta")
    out = quant_fused.int8_cross(q8, g8)
    assert tuple(out.shape) == (3, 7) and out.dtype == torch.float32


@pytest.mark.cuda
def test_cuda_int8_cross_at_2048_columns(rng):
    """On the card: the sliced float32 route at D = 2,048 equals the int32
    product on the CPU, with TF32 on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run by chip_smoke.py)")
    q8 = _t(rng.integers(-127, 128, size=(33, 2048)).astype(np.int8))
    g8 = _t(rng.integers(-127, 128, size=(1003, 2048)).astype(np.int8))
    want = quant_fused.int8_cross(q8, g8)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            got = quant_fused.int8_cross(q8.cuda(), g8.cuda())
            assert torch.equal(got.cpu(), want.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
