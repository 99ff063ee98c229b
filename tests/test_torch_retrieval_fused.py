"""K1: the port's fused retrieval against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode, as ``tests/test_retrieval_pallas.py``
runs it. Indices, ranks and tie order must match exactly; values (squared
eps-folded euclidean, or 1 - cos) at rtol 1e-5, with an absolute floor of
1e-5 x (|q|^2 + |g|^2) for euclidean: a near-zero distance is the
cancellation of terms that size, so its error scales with them, not with
the distance. The CUDA kernel itself is
held against the plain version by the ``cuda``-marked test at the end and
by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.ops.retrieval_pallas import retrieve_fused as jax_fused
from art_sbir_tpu_torch.ops import retrieval_fused as rf
from art_sbir_tpu_torch.ops.distance import retrieve_chunked
from art_sbir_tpu_torch.parallel.mesh import MeshSpec
from tests.torch_threads import two_torch_threads  # noqa: F401


RTOL, ATOL = 1e-5, 1e-6


def _inputs(rng, n, q, d=64):
    g = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    pos = rng.integers(0, n, size=q).astype(np.int32)
    return queries, g, pos


def _atol(queries, g, metric):
    if metric == "cosine":
        return ATOL
    return RTOL * float(np.max(np.sum(queries ** 2, 1))
                        + np.max(np.sum(g ** 2, 1)))


def _both(queries, g, pos, k=10, metric="euclidean", with_ranks=True,
          tile_q=8, tile_n=128):
    r0, v0, i0 = jax_fused(jnp.asarray(queries), jnp.asarray(g),
                           jnp.asarray(pos), k=k, tile_q=tile_q,
                           tile_n=tile_n, interpret=True, metric=metric,
                           with_ranks=with_ranks)
    r1, v1, i1 = rf.retrieve_fused(torch.from_numpy(queries),
                                   torch.from_numpy(g), torch.from_numpy(pos),
                                   k=k, metric=metric, with_ranks=with_ranks)
    return (np.asarray(r0), np.asarray(v0), np.asarray(i0),
            r1.numpy(), v1.numpy(), i1.numpy())


def _assert_same(r0, v0, i0, r1, v1, i1, atol=ATOL):
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(r1, r0)
    np.testing.assert_allclose(v1, v0, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("n,q,tile_q,tile_n", [
    (300, 8, 8, 128), (128, 4, 8, 128), (1000, 16, 8, 256),
    (517, 37, 16, 128), (1003, 5, 8, 128)])
def test_matches_pallas_kernel(rng, metric, n, q, tile_q, tile_n):
    queries, g, pos = _inputs(rng, n, q)
    _assert_same(*_both(queries, g, pos, metric=metric, tile_q=tile_q,
                        tile_n=tile_n))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_without_ranks_matches_pallas_kernel(rng, metric):
    """with_ranks=False (the serving path): same top-k, zero ranks."""
    queries, g, pos = _inputs(rng, 520, 12, d=32)
    r0, v0, i0, r1, v1, i1 = _both(queries, g, pos, k=7, metric=metric,
                                   with_ranks=False, tile_n=256)
    _assert_same(r0, v0, i0, r1, v1, i1)
    assert not r1.any()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_duplicated_rows_tie_order(rng, metric):
    """Duplicated gallery rows tie exactly: ranks and top-k order them by
    gallery index, on both packages."""
    d = 16
    base = rng.standard_normal((40, d)).astype(np.float32)
    g = np.concatenate([base, base[:20]], axis=0)  # 40..59 copy 0..19
    queries = base[[3, 7, 11]] + 0.01 * rng.standard_normal(
        (3, d)).astype(np.float32)
    pos = np.array([3, 7, 51], np.int32)  # 51 duplicates row 11
    r0, v0, i0, r1, v1, i1 = _both(queries, g, pos, metric=metric)
    _assert_same(r0, v0, i0, r1, v1, i1, atol=_atol(queries, g, metric))
    assert list(i1[0, :2]) == [3, 43] and v1[0, 0] == v1[0, 1]
    assert r1[2] == 1  # row 11 ties with the positive 51 at a smaller index


def test_self_retrieval(rng):
    g = rng.standard_normal((256, 32)).astype(np.float32)
    pos = np.array([5, 100, 200], np.int32)
    r, v, i = rf.retrieve_fused(torch.from_numpy(g[pos]), torch.from_numpy(g),
                                torch.from_numpy(pos), k=5)
    assert r.tolist() == [0, 0, 0] and i[:, 0].tolist() == [5, 100, 200]
    np.testing.assert_allclose(v[:, 0].numpy(), 0.0, atol=1e-4)


def test_prep_norms_op_order_matches_jax(rng):
    """qq' and gg' in the TPU kernel's op order (same float32 ops, sums in
    each library's reduction order)."""
    from art_sbir_tpu.ops.retrieval_pallas import _prep_norms as jax_prep

    queries, g, pos = _inputs(rng, 300, 9)
    for metric in ("euclidean", "cosine"):
        want = jax_prep(jnp.asarray(queries), jnp.asarray(g),
                        jnp.asarray(pos), metric)[:2]
        got = (rf.query_norms(torch.from_numpy(queries), metric),
               rf.gallery_norms(torch.from_numpy(g), metric))
        for a, b in zip(got, want):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_precomputed_gallery_norms_give_the_same_sweep(rng, metric):
    """An engine passes its gallery's norms, computed once; the sweep is
    bit-identical to one that computes them itself."""
    tq, tg, tp = (torch.from_numpy(a) for a in _inputs(rng, 300, 9))
    gg = rf.gallery_norms(tg, metric)
    assert tuple(gg.shape) == (1, 300)
    want = rf.retrieve_fused_core(tq, tg, tp, k=7, metric=metric)
    got = rf.retrieve_fused_core(tq, tg, tp, k=7, metric=metric, gg=gg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device_get", [False, True])
@pytest.mark.parametrize("with_ranks", [False, True])
def test_certificate_fallback(rng, monkeypatch, device_get, with_ranks):
    """A row whose certificate fails is recomputed by the exact route and
    counted; the merged result equals the exact route's."""
    queries, g, pos = _inputs(rng, 200, 6, d=32)
    tq, tg, tp = (torch.from_numpy(a) for a in (queries, g, pos))
    sweep = rf.fused_sweep

    def flag_rows(*a, **kw):
        ranks, vals, idx, exact = sweep(*a, **kw)
        exact = exact.clone()
        exact[[1, 4]] = 0
        vals = torch.full_like(vals, 7.0)  # wrong values on every row
        return ranks, vals, idx, exact

    monkeypatch.setattr(rf, "fused_sweep", flag_rows)
    before = rf.counters.fallback_rows
    r, v, i = rf.retrieve_fused(tq, tg, tp, k=5, with_ranks=with_ranks,
                                device_get=device_get)
    assert rf.counters.fallback_rows - before == 2
    assert isinstance(v, np.ndarray) == device_get
    r0, v0, i0 = retrieve_chunked(tq, tg, tp, k=5)
    v, i, r = np.asarray(v), np.asarray(i), np.asarray(r)
    np.testing.assert_array_equal(i[[1, 4]], i0.numpy()[[1, 4]])
    np.testing.assert_allclose(v[[1, 4]], v0.numpy()[[1, 4]] ** 2, rtol=1e-6)
    assert (v[[0, 2, 3, 5]] == 7.0).all()  # certified rows kept as swept
    want_r = r0.numpy()[[1, 4]] if with_ranks else 0
    np.testing.assert_array_equal(r[[1, 4]], want_r)


def test_guards(rng):
    queries, g, pos = (torch.from_numpy(a) for a in _inputs(rng, 8, 2, d=16))
    with pytest.raises(ValueError, match="exceeds gallery size"):
        rf.retrieve_fused(queries, g, pos, k=16)
    with pytest.raises(ValueError, match="unknown precision"):
        rf.retrieve_fused(queries, g, pos, k=4, precision="fast")
    # the sharded form bounds k by a shard's rows (4 on 2 CPU shards)
    mesh = MeshSpec(2).build([torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="per-shard gallery size 4"):
        rf.retrieve_fused_sharded(queries, g, pos, mesh, k=5)
    with pytest.raises(ValueError, match="metric"):
        rf.retrieve_fused(queries, g, pos, k=4, metric="manhattan")


def test_cpu_route_launches_no_kernel(rng):
    queries, g, pos = (torch.from_numpy(a) for a in _inputs(rng, 64, 3))
    before = rf.counters.launches
    rf.retrieve_fused(queries, g, pos, k=4)
    assert rf.counters.launches == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(rng):
    """On the card: K1 against its plain version at a ragged N."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run by chip_smoke.py)")
    queries, g, pos = _inputs(rng, 1003, 37, d=64)
    dev = torch.device("cuda")
    tq, tg, tp = (torch.from_numpy(a).to(dev) for a in (queries, g, pos))
    qq = rf.query_norms(tq, "euclidean")
    gg = rf.gallery_norms(tg, "euclidean")
    args = (tq, qq, tp.int().reshape(-1, 1).contiguous(), tg, gg)
    out = rf.fused_sweep_cuda(*args, k=10, metric="euclidean",
                              with_ranks=True)
    ref = rf.fused_sweep_reference(*args, k=10, metric="euclidean",
                                   with_ranks=True)
    np.testing.assert_array_equal(out[2].cpu().numpy(), ref[2].cpu().numpy())
    np.testing.assert_allclose(out[1].cpu().numpy(), ref[1].cpu().numpy(),
                               rtol=1e-5)
    assert np.abs(out[0].cpu().numpy() - ref[0].cpu().numpy()).max() <= 2


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run by chip_smoke.py)")


def _cuda_args(queries, g, pos, metric, dtype):
    """K1's operands on the card: norms from the float32 arrays, the
    cross term's operands in ``dtype``."""
    dev = torch.device("cuda")
    tq, tg, tp = (torch.from_numpy(a).to(dev) for a in (queries, g, pos))
    return (tq.to(dtype).contiguous(), rf.query_norms(tq, metric),
            tp.int().reshape(-1, 1).contiguous(), tg.to(dtype).contiguous(),
            rf.gallery_norms(tg, metric))


def _offset_copies(rng, q, d=64):
    """A gallery of 8 tiles and 3 rows in which one row has a copy at every
    offset mod 128 of a tile (128 equal rows), and ``q`` equal queries
    near it whose positive is the last copy."""
    g = rng.standard_normal((128 * 8 + 3, d)).astype(np.float32)
    src = 5
    copies = sorted([src] + [128 * (o % 8) + o for o in range(128)
                             if o != src])
    g[copies] = g[src]
    near = g[src] + 0.05 * rng.standard_normal(d).astype(np.float32)
    queries = np.repeat(near[None], q, axis=0)
    pos = np.full(q, copies[-1], np.int32)
    return queries, g, pos, copies


def _assert_offset_ties(out, copies):
    """Every copy ties exactly with every other, in every query's row, in
    index order; the positive (the last copy) ranks behind the other 127."""
    ranks, vals, idx = (t.cpu().numpy() for t in out[:3])
    assert (idx == np.array(copies, np.int32)[None, :]).all()
    assert (vals == vals[0, 0]).all()
    assert (ranks == len(copies) - 1).all()


FORMS = {"float32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 128])
@pytest.mark.parametrize("q", [1, 7, 8, 9, 16, 17, 32, 33, 512])
@pytest.mark.parametrize("form", FORMS)
def test_cuda_query_tiles(rng, form, q, k):
    """On the card: K1 in each form against its plain version across the
    query tiles and their edges, k at both ends, a ragged N. Float32:
    indices exact, values at rtol 1e-5. Bf16: values within the sum-order
    bound (``rf.sum_order_bound``, its largest in the row), and each index
    exact unless the plain version's distance of the kernel's column there
    lies within twice that bound of the plain version's value (at k = 128 of 1,003 columns some
    neighbours lie closer than the two sums' orders can tell apart)."""
    _cuda_or_skip()
    n = 1003
    queries, g, pos = _inputs(rng, n, q, d=64)
    for metric in ("euclidean", "cosine"):
        args = _cuda_args(queries, g, pos, metric, FORMS[form])
        kw = dict(k=k, metric=metric, with_ranks=True)
        out = rf.fused_sweep_cuda(*args, **kw)
        ref = rf.fused_sweep_reference(*args, **kw)
        if form == "float32":
            np.testing.assert_array_equal(out[2].cpu().numpy(),
                                          ref[2].cpu().numpy())
            np.testing.assert_allclose(out[1].cpu().numpy(),
                                       ref[1].cpu().numpy(), rtol=1e-5,
                                       atol=1e-6)
        else:
            bound = rf.sum_order_bound(args[0], args[3], ref[2], args[1],
                                       args[4], metric).amax(1, keepdim=True)
            assert bool((torch.abs(out[1] - ref[1]) <= bound).all())
            _, v_all, i_all, _ = rf.fused_sweep_reference(
                *args, k=n, metric=metric, with_ranks=False)
            plain = torch.empty_like(v_all).scatter_(1, i_all.long(), v_all)
            at_out = torch.gather(plain, 1, out[2].long())
            moved = out[2] != ref[2]
            assert bool((torch.abs(at_out - ref[1])
                         <= 2 * bound)[moved].all())
            cols = torch.sort(out[2], 1).values  # each column once
            assert bool((cols[:, 1:] > cols[:, :-1]).all())
        assert np.abs(out[0].cpu().numpy()
                      - ref[0].cpu().numpy()).max() <= 2
        assert out[3].cpu().numpy().all()


@pytest.mark.cuda
@pytest.mark.parametrize("q", [8, 32, 40])
@pytest.mark.parametrize("form", FORMS)
def test_cuda_copies_at_every_tile_offset_tie(rng, form, q):
    """On the card: a row copied to every offset mod 128 of a tile gives
    one value in every query's row (the queries at every offset of their
    tile), the copies in index order, and the positive's earlier copies
    count toward its rank: in the bf16 form too, whose positive's distance
    comes from the sweep's own tensor-core arithmetic."""
    _cuda_or_skip()
    queries, g, pos, copies = _offset_copies(rng, q)
    args = _cuda_args(queries, g, pos, "euclidean", FORMS[form])
    _assert_offset_ties(rf.fused_sweep_cuda(*args, k=128, metric="euclidean",
                                            with_ranks=True), copies)
