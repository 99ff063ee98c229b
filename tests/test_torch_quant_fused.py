"""K2: the port's int8 candidate scan against the JAX package's Pallas
kernel, on the CPU.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode, as ``tests/test_ops_quant.py`` runs
it. Both are fed the JAX package's own quantized arrays. The TPU kernel
certifies each row (its per-lane files and segment fold can drop a
candidate); on every row it certifies, candidate indices and their scores
are bit-identical to the port's, in the same (score, index) order: the
same integers go through the same float32 ops. The port's routes are exact
by construction and certify every row. The CUDA kernel itself is held
against the plain version by the ``cuda``-marked test at the end and by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.ops import quant as jq
from art_sbir_tpu.ops.retrieval_pallas import (
    quant_candidates_fused as jax_candidates)
from art_sbir_tpu_torch.ops import quant as pq
from art_sbir_tpu_torch.ops import quant_fused as qf
from tests.torch_threads import two_torch_threads  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_quantized(rng, n, q, d, metric):
    gal = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    qg = jq.quantize_gallery(jnp.asarray(gal), metric)
    qn = jnp.asarray(qs)
    if metric == "cosine":
        qn = jq._l2_normalize(qn)
    q8, s_q = jq._symmetric_quantize(qn)
    return (q8, s_q, qg.q8, qg.scale, qg.sq_norm), gal, qs


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("n,q,r", [(1000, 8, 40), (517, 13, 24)])
def test_plain_scan_matches_pallas_kernel(rng, metric, n, q, r):
    arrays, _, _ = _jax_quantized(rng, n, q, 64, metric)
    # no segment fold: the TPU kernel then certifies most rows
    jv, ji, jc = jax_candidates(*arrays, r=r, metric=metric, tile_n=256,
                                interpret=True, seg_reduce=1)
    pv, pi, pc = qf.quant_candidates_fused(*(_t(a) for a in arrays), r=r,
                                           metric=metric)
    ok = np.asarray(jc).astype(bool)
    assert ok.sum() >= q // 2, ok  # enough certified rows to compare
    assert pi.dtype == torch.int32 and tuple(pi.shape) == (q, r)
    np.testing.assert_array_equal(pi.numpy()[ok], np.asarray(ji)[ok])
    np.testing.assert_array_equal(pv.numpy()[ok], np.asarray(jv)[ok])
    assert pc.tolist() == [1] * q


def test_plain_scan_keeps_the_earlier_of_tied_rows(rng):
    """Duplicated gallery rows have equal codes and equal scores: at the
    r-th boundary the earlier index wins, as in ``lax.top_k``."""
    gal = rng.standard_normal((400, 32)).astype(np.float32)
    gal[[50, 120, 200, 333]] = gal[7]
    qg = pq.quantize_gallery(torch.from_numpy(gal))
    q8, s_q = pq._symmetric_quantize(torch.from_numpy(gal[[7]]))
    vals, idx, _ = qf.quant_candidates_fused(q8, s_q, qg.q8, qg.scale,
                                             qg.sq_norm, r=3)
    assert idx.tolist() == [[7, 50, 120]]
    assert vals[0, 0] == vals[0, 1] == vals[0, 2]


@pytest.mark.parametrize("device_get", [False, True])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_certificate_fallback(rng, monkeypatch, device_get, metric):
    """Rows whose certificate fails are recomputed by the plain scan
    (padded to a power of two) and counted; the result equals
    ``retrieve_quantized``'s."""
    gal = rng.standard_normal((300, 32)).astype(np.float32)
    qs = rng.standard_normal((7, 32)).astype(np.float32)
    tq, tg = torch.from_numpy(qs), torch.from_numpy(gal)
    qg = pq.quantize_gallery(tg, metric)
    sweep = qf.quant_candidates_fused

    def flag_rows(*a, **kw):
        vals, idx, exact = sweep(*a, **kw)
        exact = exact.clone()
        exact[[1, 4, 5]] = 0
        idx = torch.flip(idx, dims=[0])  # wrong candidates on every row
        return vals, idx, exact

    monkeypatch.setattr(qf, "quant_candidates_fused", flag_rows)
    before = qf.counters.fallback_rows
    v, i = pq.retrieve_quantized_fused(tq, qg, tg, k=5, rerank_factor=4,
                                       device_get=device_get)
    assert qf.counters.fallback_rows - before == 3
    assert isinstance(v, np.ndarray) == device_get
    v0, i0 = pq.retrieve_quantized(tq, qg, tg, k=5, rerank_factor=4)
    v, i = np.asarray(v), np.asarray(i)
    np.testing.assert_array_equal(i[[1, 4, 5]], i0.numpy()[[1, 4, 5]])
    np.testing.assert_array_equal(v[[1, 4, 5]], v0.numpy()[[1, 4, 5]])
    # certified rows keep the (wrong) candidates they were given
    assert not np.array_equal(i[[0, 2, 3, 6]], i0.numpy()[[0, 2, 3, 6]])


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_fused_route_matches_plain_route_and_jax(rng, metric):
    """Without failed rows the streamed route is the plain one: identical
    indices and values; and it agrees with the JAX package's streamed
    route on separated data."""
    gal = rng.standard_normal((700, 64)).astype(np.float32)
    qs = gal[9:20] + 0.04 * rng.standard_normal((11, 64)).astype(np.float32)
    tq, tg = torch.from_numpy(qs), torch.from_numpy(gal)
    qg = pq.quantize_gallery(tg, metric)
    v0, i0 = pq.retrieve_quantized(tq, qg, tg, k=6, rerank_factor=4)
    v1, i1 = pq.retrieve_quantized_fused(tq, qg, tg, k=6, rerank_factor=4)
    assert torch.equal(i1, i0) and torch.equal(v1, v0)
    jv, ji = jq.retrieve_quantized_fused(
        jnp.asarray(qs), jq.quantize_gallery(jnp.asarray(gal), metric),
        jnp.asarray(gal), k=6, rerank_factor=4)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6 if metric == "cosine" else 0.0)


def _jax_scores_top_r(arrays, r, metric):
    """``_quant_core``'s approximate score in its own float32 op order and
    its ``lax.top_k`` candidate order, from the JAX package's arrays."""
    import jax

    q8, s_q, g8, g_scale, g_sq = arrays
    dot = jax.lax.dot_general(
        q8, g8, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32) * (s_q[:, None] * g_scale[None, :])
    approx = g_sq[None, :] - 2.0 * dot if metric == "euclidean" else -dot
    neg, idx = jax.lax.top_k(-approx, r)
    return -np.asarray(neg), np.asarray(idx)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("r", [160, 256, 1024])
def test_plain_scan_beyond_128_matches_jax_core(rng, metric, r):
    """Budgets past 128 (the JAX default takes up to 8 * 128): the plain
    scan's candidates are ``_quant_core``'s candidate set, and its scores and
    order are bit-identical to that function's scoring and ``lax.top_k``
    (earlier index first among equal scores)."""
    arrays, gal, qs = _jax_quantized(rng, 2000, 8, 64, metric)
    _, core_idx = jq._quant_core(jnp.asarray(qs), *arrays[2:],
                                 jnp.asarray(gal), metric=metric, k=r, r=r)
    jv, ji = _jax_scores_top_r(arrays, r, metric)
    pv, pi, pc = qf.quant_candidates_fused(*(_t(a) for a in arrays), r=r,
                                           metric=metric)
    assert pi.dtype == torch.int32 and tuple(pi.shape) == (8, r)
    np.testing.assert_array_equal(np.sort(pi.numpy(), 1),
                                  np.sort(np.asarray(core_idx), 1))
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_array_equal(pv.numpy(), jv)
    assert pc.tolist() == [1] * 8


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_fused_route_at_1024_candidates(rng, metric):
    """k = 128 at rerank_factor 8: r = 1,024, the route's cap. The streamed
    route equals the plain one, and its indices equal the JAX package's
    plain int8 route."""
    gal = rng.standard_normal((3000, 32)).astype(np.float32)
    qs = gal[5:11] + 0.3 * rng.standard_normal((6, 32)).astype(np.float32)
    tq, tg = torch.from_numpy(qs), torch.from_numpy(gal)
    qg = pq.quantize_gallery(tg, metric)
    v0, i0 = pq.retrieve_quantized(tq, qg, tg, k=128, rerank_factor=8)
    v1, i1 = pq.retrieve_quantized_fused(tq, qg, tg, k=128, rerank_factor=8)
    assert tuple(i1.shape) == (6, 128)
    assert torch.equal(i1, i0) and torch.equal(v1, v0)
    _, ji = jq.retrieve_quantized(jnp.asarray(qs),
                                  jq.quantize_gallery(jnp.asarray(gal), metric),
                                  jnp.asarray(gal), k=128, rerank_factor=8)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji))


def test_guards_carry_the_jax_messages(rng):
    gal = rng.standard_normal((64, 32)).astype(np.float32)
    qg = pq.quantize_gallery(torch.from_numpy(gal))
    q8, s_q = pq._symmetric_quantize(torch.from_numpy(gal[:4]))
    args = (q8, s_q, qg.q8, qg.scale, qg.sq_norm)
    with pytest.raises(ValueError, match="exceeds gallery size"):
        qf.quant_candidates_fused(*args, r=65)
    with pytest.raises(ValueError, match="unknown metric"):
        qf.quant_candidates_fused(*args, r=8, metric="l2")
    assert qf.quant_candidates_fused(*args, r=64)[1].shape == (4, 64)


def test_cpu_route_launches_no_kernel(rng):
    gal = rng.standard_normal((64, 32)).astype(np.float32)
    qg = pq.quantize_gallery(torch.from_numpy(gal))
    before = qf.counters.launches
    pq.retrieve_quantized_fused(torch.from_numpy(gal[:3]), qg,
                                torch.from_numpy(gal), k=4)
    assert qf.counters.launches == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(rng):
    """On the card: K2 against its plain version at a ragged N and Q,
    scores and indices bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run by chip_smoke.py)")
    dev = torch.device("cuda")
    gal = torch.from_numpy(rng.standard_normal((1003, 64)).astype(
        np.float32)).to(dev)
    qs = torch.from_numpy(rng.standard_normal((37, 64)).astype(
        np.float32)).to(dev)
    for metric in ("euclidean", "cosine"):
        qg = pq.quantize_gallery(gal, metric)
        q8, s_q = pq._quantize_queries(qs, metric)
        args = (q8, s_q, qg.q8, qg.scale, qg.sq_norm)
        out = qf.quant_candidates_cuda(*args, r=40, metric=metric)
        ref = qf.quant_candidates_reference(*args, r=40, metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(out[1], ref[1]) and torch.equal(out[0], ref[0])
        assert bool(out[2].all())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [256, 512, 1024])
def test_cuda_kernel_beyond_128_matches_plain_version(rng, r):
    """On the card: K2 with 16 (r > 512) or 32 queries per block and the
    tournament merge, against its plain version, bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run by chip_smoke.py)")
    dev = torch.device("cuda")
    gal = torch.from_numpy(rng.standard_normal((20_003, 64)).astype(
        np.float32)).to(dev)
    qs = torch.from_numpy(rng.standard_normal((37, 64)).astype(
        np.float32)).to(dev)
    for metric in ("euclidean", "cosine"):
        qg = pq.quantize_gallery(gal, metric)
        q8, s_q = pq._quantize_queries(qs, metric)
        args = (q8, s_q, qg.q8, qg.scale, qg.sq_norm)
        out = qf.quant_candidates_cuda(*args, r=r, metric=metric)
        ref = qf.quant_candidates_reference(*args, r=r, metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(out[1], ref[1]) and torch.equal(out[0], ref[0])
        assert bool(out[2].all())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [40, 1024])
def test_cuda_kernel_consecutive_ties_cross_the_buffer(rng, r):
    """On the card: 2,000 equal rows at consecutive indices, the queries'
    best: their ties cross the selection buffer's flushes and the r-th
    candidate, and the smaller indices win, bit-identical to the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run by chip_smoke.py)")
    dev = torch.device("cuda")
    gal = rng.standard_normal((20_003, 64)).astype(np.float32)
    gal[3_000:5_000] = gal[3_000]
    qs = gal[[3_000] * 5] + 0.01 * rng.standard_normal((5, 64)).astype(
        np.float32)
    qg = pq.quantize_gallery(torch.from_numpy(gal).to(dev))
    q8, s_q = pq._quantize_queries(torch.from_numpy(qs).to(dev), "euclidean")
    args = (q8, s_q, qg.q8, qg.scale, qg.sq_norm)
    out = qf.quant_candidates_cuda(*args, r=r, metric="euclidean")
    ref = qf.quant_candidates_reference(*args, r=r, metric="euclidean")
    torch.cuda.synchronize()
    assert torch.equal(out[1], ref[1]) and torch.equal(out[0], ref[0])
    want = torch.arange(3_000, 3_000 + r, dtype=torch.int32, device=dev)
    assert bool((out[1] == want).all()) and bool(out[2].all())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [40, 1024])
def test_cuda_kernel_worst_order(rng, r):
    """On the card: a gallery sorted by descending score against the
    query, so every row beats all rows before it and is admitted; K2
    against its plain version, bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run by chip_smoke.py)")
    dev = torch.device("cuda")
    gal = torch.from_numpy(rng.standard_normal((20_003, 64)).astype(
        np.float32)).to(dev)
    qs = torch.from_numpy(rng.standard_normal((1, 64)).astype(
        np.float32)).to(dev)
    qg = pq.quantize_gallery(gal)
    q8, s_q = pq._quantize_queries(qs, "euclidean")
    score = qf.approx_scores(q8, s_q, qg.q8, qg.scale, qg.sq_norm,
                             "euclidean")[0]
    order = torch.argsort(score, descending=True)
    args = (q8.expand(3, 64).contiguous(), s_q.expand(3).contiguous(),
            qg.q8[order].contiguous(), qg.scale[order].contiguous(),
            qg.sq_norm[order].contiguous())
    out = qf.quant_candidates_cuda(*args, r=r, metric="euclidean")
    ref = qf.quant_candidates_reference(*args, r=r, metric="euclidean")
    torch.cuda.synchronize()
    assert torch.equal(out[1], ref[1]) and torch.equal(out[0], ref[0])
    assert bool(out[2].all())


@pytest.mark.cuda
def test_k2_parts_probe_runs():
    """On the card: the probe builds K2's variants and times each part."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run by chip_smoke.py)")
    from art_sbir_tpu_torch.scripts import probe_k2_parts

    assert probe_k2_parts.main(["20000", "--reps", "1"]) == 0
