"""The row-sharded routes' one-launch forms and their cross-shard merge.

On the CPU (the plain versions of the kernels):

* ``merge_shard_runs_reference`` (the plain version of K1's cross-shard
  merge kernel) against JAX's ``lexsort_topk_merge`` on numpy partials:
  values and indices identical, with equal values across shards,
  sentinels and unfilled slots; its rank sums and certificate AND against
  numpy's.
* sharded K1 and the sharded int8 route against JAX's on its 8-device CPU
  mesh, on a mesh that names one device 8 times (the layout whose shards
  share one launch) and on one that names two devices (CPU and CPU:0, so
  that the per-device results merge across devices), with the tolerances
  of ``tests/test_torch_sharded.py``; the two meshes' results bit for bit.
* K2 over several shards in one call (``quant_candidates_shards``) against
  each shard's own scan.

On the card (marked ``cuda``, skipped here): the merge kernel, K2 over the
shards and K1 over the shards against their plain versions, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import art_sbir_tpu.ops.retrieval_pallas as jax_pallas
from art_sbir_tpu.ops import quant as jq
from art_sbir_tpu.ops.sharded import lexsort_topk_merge as jax_merge
from art_sbir_tpu.parallel import mesh as jax_mesh
from art_sbir_tpu_torch.ops import quant as pq
from art_sbir_tpu_torch.ops import quant_fused as qf
from art_sbir_tpu_torch.ops import retrieval_fused as rf
from art_sbir_tpu_torch.ops.sharded import (device_groups,
                                            merge_shard_runs_reference)
from art_sbir_tpu_torch.parallel import mesh as port_mesh
from tests.torch_threads import two_torch_threads  # noqa: F401


CPU = torch.device("cpu")
RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _one_device():
    return port_mesh.MeshSpec(8).build([CPU] * 8)


def _two_devices():
    """8 shards over two named devices (4 each): two groups."""
    return port_mesh.MeshSpec(8).build([CPU] * 4 + [torch.device("cpu", 0)]
                                       * 4)


def _jax_mesh8():
    return jax_mesh.MeshSpec(data=len(jax.devices())).build()


def _partials(rng, s, q, k, n):
    """(S, Q, k) runs ascending by (value, global index): small-integer
    values (ties within and across shards), shard i's indices in its own
    rows, two unfilled slots (3e38 at n) in a few runs; (S, Q) rank
    partials and certificates with some 0."""
    vals = np.sort(rng.integers(0, 4, (s, q, k)).astype(np.float32), 2)
    nl = n // s
    idx = np.stack([np.stack([np.sort(rng.choice(
        np.arange(i * nl, (i + 1) * nl), k, replace=False))
        for _ in range(q)]) for i in range(s)]).astype(np.int32)
    for i in range(min(s, 3)):
        vals[i, i % q, -2:], idx[i, i % q, -2:] = rf.BIG, n
    ranks = rng.integers(0, 50, (s, q)).astype(np.int32)
    exact = (rng.random((s, q)) > 0.1).astype(np.int32)
    return vals, idx, ranks, exact


@pytest.mark.parametrize("s,q,k", [(8, 6, 4), (3, 5, 10), (2, 7, 3)])
def test_merge_shard_runs_matches_jax(rng, s, q, k):
    n = s * k * 10
    vals, idx, ranks, exact = _partials(rng, s, q, k, n)
    v0, i0 = jax_merge(jnp.asarray(vals), jnp.asarray(idx), k)
    r1, v1, i1, e1 = merge_shard_runs_reference(
        _t(vals), _t(idx), k, n, ranks=_t(ranks), exact=_t(exact))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))
    np.testing.assert_array_equal(v1.numpy(), np.asarray(v0))
    np.testing.assert_array_equal(r1.numpy(), ranks.sum(0))
    np.testing.assert_array_equal(e1.numpy(), exact.all(0).astype(np.int32))
    # the dispatcher takes the plain version for CPU tensors; no ranks,
    # no certificates: None and all ones; runs given as (Q, S, k) views
    r2, v2, i2, e2 = rf.merge_shard_runs(
        _t(vals.transpose(1, 0, 2)).transpose(0, 1),
        _t(idx.transpose(1, 0, 2)).transpose(0, 1), k, n)
    assert r2 is None and bool((e2 == 1).all())
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i0))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v0))


def test_device_groups():
    assert device_groups(_one_device()) == [(CPU, list(range(8)))]
    assert device_groups(_two_devices()) == [
        (CPU, [0, 1, 2, 3]), (torch.device("cpu", 0), [4, 5, 6, 7])]


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_fused_sharded_one_and_two_devices_match_jax(rng, metric):
    """Sharded K1 over one device named 8 times and over two devices,
    against JAX's 8-device sharded K1, with copies of rows across shards
    and positives at the shards' edges and on the copies."""
    n, q, d = 1024, 16, 32  # 128 rows a shard
    gal = rng.standard_normal((n, d)).astype(np.float32)
    gal[600:606] = gal[:6]  # copies in shard 4 (the second device)
    pos = rng.integers(0, n, size=q).astype(np.int32)
    pos[:5] = [0, 127, 128, 603, n - 1]
    queries = (gal[pos] + 0.1 * rng.standard_normal((q, d))).astype(
        np.float32)
    want = [np.asarray(o) for o in jax_pallas.retrieve_fused_sharded(
        jnp.asarray(queries), jnp.asarray(gal), jnp.asarray(pos),
        _jax_mesh8(), k=10, tile_q=8, tile_n=128, interpret=True,
        metric=metric)]
    got = [rf.retrieve_fused_sharded(_t(queries), _t(gal), _t(pos), mesh,
                                     k=10, metric=metric)
           for mesh in (_one_device(), _two_devices())]
    for a, b in zip(*got):
        assert torch.equal(a, b)
    r1, v1, i1 = (t.numpy() for t in got[0])
    np.testing.assert_array_equal(i1, want[2])
    np.testing.assert_array_equal(r1, want[0])
    atol = 1e-6 if metric == "cosine" else RTOL * float(
        np.max(np.sum(queries ** 2, 1)) + np.max(np.sum(gal ** 2, 1)))
    np.testing.assert_allclose(v1, want[1], rtol=RTOL, atol=atol)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("with_ranks", [True, False])
def test_fused_sharded_two_devices_equals_unsharded(rng, precision,
                                                    with_ranks):
    """Over two devices (the positive's distances summed across them, the
    devices' results merged) the plain route equals unsharded K1 bit for
    bit; positives before, in and past the gallery."""
    n, q, d = 256, 13, 24
    gal = rng.standard_normal((n, d)).astype(np.float32)
    gal[200:210] = gal[:10]
    pos = rng.integers(0, n, size=q).astype(np.int32)
    pos[:4] = [-1, n, 5, 205]
    queries = (gal[np.clip(pos, 0, n - 1)] + 0.1 * rng.standard_normal(
        (q, d))).astype(np.float32)
    kw = dict(k=12, precision=precision, with_ranks=with_ranks)
    want = rf.retrieve_fused(_t(queries), _t(gal), _t(pos), **kw)
    got = rf.retrieve_fused_sharded(_t(queries), _t(gal), _t(pos),
                                    _two_devices(), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_quantized_sharded_one_and_two_devices_match_jax(rng, metric):
    """The sharded int8 route on its K2 path (the plain version of K2 over
    each device's shards, their rerank at once) and on its per-shard plain
    path, over one and two devices, against JAX's plain per-shard route."""
    n, d, q, k = 1024, 64, 12, 5
    gal = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    want = jq.retrieve_quantized_sharded(
        jnp.asarray(qs), jq.quantize_gallery(jnp.asarray(gal), metric),
        jnp.asarray(gal), _jax_mesh8(), k=k, rerank_factor=3,
        use_kernel=False)
    qg = pq.quantize_gallery(_t(gal), metric)
    outs = [pq.retrieve_quantized_sharded(_t(qs), qg, _t(gal), mesh, k=k,
                                          rerank_factor=3,
                                          use_kernel=use_kernel)
            for mesh in (_one_device(), _two_devices())
            for use_kernel in (True, False)]
    for v, i in outs[1:]:
        assert torch.equal(v, outs[0][0]) and torch.equal(i, outs[0][1])
    v1, i1 = (t.numpy() for t in outs[0])
    np.testing.assert_array_equal(i1, np.asarray(want[1]))
    np.testing.assert_allclose(v1, np.asarray(want[0]), rtol=1e-6,
                               atol=1e-6 if metric == "cosine" else 0.0)


def test_quant_candidates_shards_matches_each_scan(rng):
    """K2's plain version over 4 shards at once: each shard's own scan,
    in index order, as global rows."""
    n, d, q, r = 512, 32, 6, 7
    gal = rng.standard_normal((n, d)).astype(np.float32)
    gal[300:302] = gal[:2]  # equal scores across shards
    qg = pq.quantize_gallery(_t(gal))
    q8, s_q = pq._symmetric_quantize(_t(rng.standard_normal(
        (q, d)).astype(np.float32)))
    shards = [pq.QuantGallery(qg.q8[i:i + 128], qg.scale[i:i + 128],
                              qg.sq_norm[i:i + 128], "euclidean")
              for i in range(0, n, 128)]
    row0 = [0, 128, 256, 384]
    vals, idx, exact = qf.quant_candidates_shards(q8, s_q, shards, row0,
                                                  r=r)
    assert vals.shape == idx.shape == (q, 4, r)
    assert exact.shape == (4, q) and bool((exact == 1).all())
    for j, (s, first) in enumerate(zip(shards, row0)):
        v, i, _ = qf.quant_candidates_reference(q8, s_q, s.q8, s.scale,
                                                s.sq_norm, r=r,
                                                metric="euclidean")
        order = torch.argsort(i, dim=1)
        assert torch.equal(idx[:, j], torch.gather(i, 1, order) + first)
        assert torch.equal(vals[:, j], torch.gather(v, 1, order))
        assert bool((idx[:, j, 1:] > idx[:, j, :-1]).all())


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_cuda_merge_and_shard_kernels_equal_plain(rng):
    """On the card: K1's cross-shard merge, K2 over 4 shards and K1 over 4
    shards of one card against their plain versions, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run by chip_smoke.py)")
    dev = torch.device("cuda")
    vals, idx, ranks, exact = (torch.from_numpy(a).to(dev) for a in
                               _partials(rng, 4, 33, 10, 4000))
    got = rf.merge_shard_runs_cuda(vals, idx, 10, 4000, ranks=ranks,
                                   exact=exact)
    want = merge_shard_runs_reference(vals, idx, 10, 4000, ranks=ranks,
                                      exact=exact)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    n, d, q = 4096, 64, 37
    gal = torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).to(dev)
    qg = pq.quantize_gallery(gal)
    shards = [pq.QuantGallery(qg.q8[i:i + 1024], qg.scale[i:i + 1024],
                              qg.sq_norm[i:i + 1024], "euclidean")
              for i in range(0, n, 1024)]
    q8, s_q = pq._symmetric_quantize(gal[:q] + 0.01)
    row0 = [0, 1024, 2048, 3072]
    got = qf.quant_candidates_shards_cuda(q8, s_q, shards, row0, r=40,
                                          metric="euclidean")
    want = qf.quant_candidates_shards_reference(q8, s_q, shards, row0, r=40,
                                                metric="euclidean")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pos = torch.arange(q, device=dev, dtype=torch.int32) * 97
    x = (gal[pos.long()] + 0.1).contiguous()
    mesh = port_mesh.MeshSpec(4).build([dev] * 4)
    want = rf.retrieve_fused_core(x, gal, pos, k=10)
    got = rf.retrieve_fused_sharded_core(x, gal, pos, mesh, k=10)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
