"""K1's bf16 form (``precision='default'``): the port against the JAX
package's Pallas kernel, on the CPU.

The JAX kernel runs in Pallas interpret mode with ``tile_q=8``,
``tile_n=256``; the port's wrapper runs its plain PyTorch version. In both,
only the cross term sees bf16 operands: the norms come from the caller's
arrays in float32, and a gallery passed as bf16 gives norms of its bf16
values. Top-k indices must be identical and values within rtol 1e-5, with
the euclidean absolute floor of ``tests/test_torch_retrieval_fused.py``
(a near-zero distance is the cancellation of terms of the size of the
norms). The positive's distance differs by design: the JAX kernel takes it
from the float32 inputs, the port from the same bf16 arithmetic as its
column. So the data here are separated: each query lies within two
standard deviations of its positive, a few tens of rows at most rank ahead
of it, and with these seeds no other row lies within the bf16 rounding of
the positive's distance; the ranks must then be equal. The CUDA kernel itself is held against the
plain version by the ``cuda``-marked test at the end, by the query-tile and
tie tests of ``tests/test_torch_retrieval_fused.py`` (both forms) and by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.ops.retrieval_pallas import retrieve_fused as jax_fused
from art_sbir_tpu_torch.ops import retrieval_fused as rf
from tests.torch_threads import two_torch_threads  # noqa: F401


RTOL = 1e-5
SPREAD = 2.0  # query noise: ranks of up to some tens of rows


def _inputs(seed, n, q, d=64):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    pos = rng.integers(0, n, size=q).astype(np.int32)
    queries = (g[pos] + SPREAD * rng.standard_normal((q, d))).astype(
        np.float32)
    return queries, g, pos


def _atol(queries, g, metric):
    if metric == "cosine":
        return 1e-6
    return RTOL * float(np.max(np.sum(queries ** 2, 1))
                        + np.max(np.sum(g ** 2, 1)))


def _both(queries, g, pos, metric, with_ranks, bf16_gallery, k=10):
    jg = jnp.asarray(g)
    tg = torch.from_numpy(g)
    if bf16_gallery:
        jg, tg = jg.astype(jnp.bfloat16), tg.to(torch.bfloat16)
    r0, v0, i0 = jax_fused(jnp.asarray(queries), jg, jnp.asarray(pos), k=k,
                           tile_q=8, tile_n=256, interpret=True,
                           precision="default", metric=metric,
                           with_ranks=with_ranks)
    r1, v1, i1 = rf.retrieve_fused(torch.from_numpy(queries), tg,
                                   torch.from_numpy(pos), k=k,
                                   precision="default", metric=metric,
                                   with_ranks=with_ranks)
    return (np.asarray(r0), np.asarray(v0), np.asarray(i0),
            r1.numpy(), v1.numpy(), i1.numpy())


@pytest.mark.parametrize("bf16_gallery", [False, True])
@pytest.mark.parametrize("with_ranks", [True, False])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("n,q", [(1000, 1), (1000, 9), (1003, 1), (1003, 9)])
def test_matches_pallas_kernel(n, q, metric, with_ranks, bf16_gallery):
    queries, g, pos = _inputs(n + q, n, q)
    r0, v0, i0, r1, v1, i1 = _both(queries, g, pos, metric, with_ranks,
                                   bf16_gallery)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(v1, v0, rtol=RTOL,
                               atol=_atol(queries, g, metric))
    np.testing.assert_array_equal(r1, r0)
    if not with_ranks:
        assert not r1.any()


def test_ranks_are_not_trivial():
    """The separated data still rank some rows ahead of the positive."""
    queries, g, pos = _inputs(1009, 1000, 9)
    ranks, _, _ = rf.retrieve_fused(torch.from_numpy(queries),
                                    torch.from_numpy(g),
                                    torch.from_numpy(pos), k=10,
                                    precision="default")
    assert ranks.max() > 0


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_duplicate_of_the_positive_ties(rng, metric):
    """Duplicated gallery rows have the same bf16 products, so they tie
    exactly and rank by index, as on the JAX kernel; the positive's earlier
    duplicate ties with the positive's own distance and counts toward its
    rank (the port's rule, in both forms)."""
    d = 16
    base = rng.standard_normal((40, d)).astype(np.float32)
    g = np.concatenate([base, base[:20]], axis=0)  # 40..59 copy 0..19
    queries = base[[3, 7, 11]] + 0.01 * rng.standard_normal(
        (3, d)).astype(np.float32)
    pos = np.array([3, 7, 51], np.int32)  # 51 duplicates row 11
    _, v0, i0, r1, v1, i1 = _both(queries, g, pos, metric, True, False)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(v1, v0, rtol=RTOL,
                               atol=_atol(queries, g, metric))
    assert list(i1[0, :2]) == [3, 43] and v1[0, 0] == v1[0, 1]
    assert list(i1[2, :2]) == [11, 51] and v1[2, 0] == v1[2, 1]
    assert r1.tolist() == [0, 0, 1]


def test_default_is_the_bf16_cross_term(rng):
    """The sweep's values are those of float32 norms and a bf16 cross term
    summed in float32, whether the gallery comes as float32 or bf16."""
    queries, g, pos = (torch.from_numpy(a) for a in _inputs(3, 300, 5))
    qb = queries.to(torch.bfloat16).float()
    gb = g.to(torch.bfloat16).float()
    for gallery, g32 in ((g, g), (g.to(torch.bfloat16), gb)):
        qq = rf.query_norms(queries, "euclidean")
        gg = rf.gallery_norms(g32, "euclidean")
        want = torch.clamp(qq + gg - 2.0 * (qb @ gb.T), min=0.0)
        _, vals, idx, _ = rf.retrieve_fused_core(queries, gallery, pos, k=7,
                                                 precision="default")
        torch.testing.assert_close(vals, torch.gather(want, 1, idx.long()),
                                   rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_sum_order_bound_holds_for_another_order(metric):
    """The bf16 form's value bound covers the distance of a bf16 cross
    term summed in float32 against the same sum taken exactly (float64):
    one route's share of the bound, so half of it must suffice."""
    queries, g, pos = (torch.from_numpy(a) for a in _inputs(8, 500, 6,
                                                             d=256))
    qb, gb = queries.to(torch.bfloat16), g.to(torch.bfloat16)
    qq, gg = rf.query_norms(queries, metric), rf.gallery_norms(g, metric)
    _, v32, idx, _ = rf.fused_sweep_reference(
        qb, qq, pos.int()[:, None], gb, gg, k=10, metric=metric,
        with_ranks=False)
    c64 = qb.double() @ gb.double().T
    if metric == "euclidean":
        d64 = torch.clamp(qq.double() + gg.double() - 2.0 * c64, min=0.0)
    else:
        d64 = 1.0 - c64 / torch.clamp(qq.double() * gg.double(), min=1e-8)
    err = torch.abs(torch.gather(d64, 1, idx.long()) - v32.double())
    bound = rf.sum_order_bound(qb, gb, idx, qq, gg, metric)
    assert bool((bound > 0).all())
    assert bool((err <= 0.5 * bound.double()).all())


def test_unknown_precision_raises(rng):
    queries, g, pos = (torch.from_numpy(a) for a in _inputs(4, 64, 2))
    with pytest.raises(ValueError, match="unknown precision"):
        rf.retrieve_fused(queries, g, pos, k=4, precision="fast")


def test_cpu_route_launches_no_kernel():
    queries, g, pos = (torch.from_numpy(a) for a in _inputs(5, 64, 3))
    before = (rf.counters.launches, rf.bf16_counters.launches)
    rf.retrieve_fused(queries, g, pos, k=4, precision="default")
    assert (rf.counters.launches, rf.bf16_counters.launches) == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: K1's bf16 form against its plain version at a ragged N,
    with the gallery as float32 and as bf16: indices exact, values within
    the sum-order bound (``rf.sum_order_bound``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run by chip_smoke.py)")
    queries, g, pos = (torch.from_numpy(a).cuda()
                       for a in _inputs(6, 1003, 37))
    for gallery in (g, g.to(torch.bfloat16)):
        qq = rf.query_norms(queries, "euclidean")
        gg = rf.gallery_norms(gallery, "euclidean")
        args = (queries.to(torch.bfloat16), qq,
                pos.int().reshape(-1, 1).contiguous(),
                gallery.to(torch.bfloat16).contiguous(), gg)
        out = rf.fused_sweep_cuda(*args, k=10, metric="euclidean",
                                  with_ranks=True)
        ref = rf.fused_sweep_reference(*args, k=10, metric="euclidean",
                                       with_ranks=True)
        np.testing.assert_array_equal(out[2].cpu().numpy(),
                                      ref[2].cpu().numpy())
        bound = rf.sum_order_bound(args[0], args[3], out[2], args[1],
                                   args[4], "euclidean")
        assert bool((torch.abs(out[1] - ref[1]) <= bound).all())
        assert np.abs(out[0].cpu().numpy() - ref[0].cpu().numpy()).max() <= 2
