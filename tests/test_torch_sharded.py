"""The port's row-sharded gallery against the JAX package's, on the CPU.

The port's shards are ``[cpu] * 8`` (one process, one device named eight
times); the JAX package runs on its 8-device virtual CPU mesh
(``tests/conftest.py``) with K1 and K2 in Pallas interpret mode at
``tile_q=8, tile_n=128``, as ``tests/test_retrieval_pallas.py`` and
``tests/test_ops_quant.py`` run them. Tolerances:

* ``lexsort_topk_merge``: values and indices identical to JAX's.
* sharded K1 against JAX's sharded K1: ranks and indices exact, values at
  rtol 1e-5 (euclidean with the absolute floor of
  ``tests/test_torch_retrieval_fused.py``: 1e-5 x (|q|^2 + |g|^2)), cross-
  shard copies of a row in the same order; against the port's own
  unsharded K1 on the CPU: bit for bit in both forms.
* the sharded int8 route: indices exact, values at rtol 1e-6 (cosine with
  an absolute 1e-6), against JAX's plain per-shard route, JAX's route with
  K2 in interpret mode, and a numpy oracle of "per-shard top-r + local
  exact rerank + merge".
* ``evaluate_retrieval(mesh=)``, ``run_inference``, the serving engine and
  ``cli/inference.py --n_devices 2`` against their unsharded runs: ranks
  and what comes from them exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import art_sbir_tpu.ops.retrieval_pallas as jax_pallas
import art_sbir_tpu.retrieval.rank as jax_rank
from art_sbir_tpu.ops import quant as jq
from art_sbir_tpu.ops.sharded import lexsort_topk_merge as jax_merge
from art_sbir_tpu.parallel import mesh as jax_mesh
import art_sbir_tpu_torch.retrieval.rank as port_rank
from art_sbir_tpu_torch.cli import inference as port_cli
from art_sbir_tpu_torch.cli import serve as port_serve
from art_sbir_tpu_torch.ops import quant as pq
from art_sbir_tpu_torch.ops import quant_fused as qf
from art_sbir_tpu_torch.ops import retrieval_fused as rf
from art_sbir_tpu_torch.ops.distance import euclidean_distance
from art_sbir_tpu_torch.ops.sharded import lexsort_topk_merge
from art_sbir_tpu_torch.parallel import mesh as port_mesh
from art_sbir_tpu_torch.retrieval import embed as port_embed
from art_sbir_tpu_torch.retrieval.server import RetrievalEngine
from art_sbir_tpu.data.synthetic import make_synthetic_sketchy
from tests.test_torch_inference import RUN, _results_folder
from tests.test_torch_rank import _features, assert_same_inference_dict
from tests.test_torch_serve import S, _png, _port_forward, data  # noqa: F401
from tests.torch_threads import two_torch_threads  # noqa: F401


CPU = torch.device("cpu")
RTOL = 1e-5


def _mesh(n=8):
    return port_mesh.MeshSpec(n).build([CPU] * n)


def _jax_mesh8():
    return jax_mesh.MeshSpec(data=len(jax.devices())).build()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ mesh

def test_mesh_helpers_match_jax():
    assert len(jax.devices()) == 8
    mesh = port_mesh.data_mesh(8, device="cpu")
    assert mesh.devices == (CPU,) * 8
    assert (mesh.axis_name,) == _jax_mesh8().axis_names
    assert mesh.distinct_devices() == [CPU]
    assert port_mesh.data_mesh(-1, device="cpu").size == 1
    for n, m in ((0, 8), (1, 8), (8, 8), (1003, 8), (5, 3)):
        assert port_mesh.pad_to_multiple(n, m) == jax_mesh.pad_to_multiple(
            n, m)
    for spec in (port_mesh.MeshSpec(9), jax_mesh.MeshSpec(9)):
        with pytest.raises(ValueError, match="wants 9 devices, only 8"):
            spec.build([CPU] * 8 if isinstance(spec, port_mesh.MeshSpec)
                       else None)
    assert port_mesh.mesh_from_args(1, device="cpu") is None
    assert port_mesh.mesh_from_args(3, device="cpu").size == 3
    # the 2-D (data, model) mesh of tensor parallelism, JAX's shape
    grid = port_mesh.mesh_from_args(2, tp_devices=2, device="cpu")
    assert (grid.n_data, grid.n_model) == tuple(
        jax_mesh.mesh_from_args(2, 2)[0].shape.values()) == (2, 2)
    assert grid.devices == (CPU,) * 4


def test_shard_rows_and_split_batch():
    x = torch.arange(24.0).reshape(12, 2)
    parts = port_mesh.shard_rows(x, _mesh(3))
    assert [p.shape[0] for p in parts] == [4, 4, 4]
    assert torch.equal(torch.cat(parts), x)
    assert parts[1].data_ptr() == x[4].data_ptr()  # a view on its device
    with pytest.raises(ValueError, match="divisible"):
        port_mesh.shard_rows(x, _mesh(5))
    assert [p.shape[0] for p in port_mesh.split_batch(x, [CPU] * 5)] == [
        3, 3, 2, 2, 2]
    assert [p.shape[0] for p in port_mesh.split_batch(x[:2], [CPU] * 5)] == [
        1, 1]


# ----------------------------------------------------------------- merge

@pytest.mark.parametrize("s,q,k", [(8, 6, 4), (3, 5, 10)])
def test_lexsort_topk_merge_matches_jax(rng, s, q, k):
    """Partials with many equal values, and sentinel slots (3e38 at N)."""
    n = s * k * 10
    vals = np.sort(rng.integers(0, 5, (s, q, k)).astype(np.float32), 2)
    idx = np.stack([np.stack([np.sort(rng.choice(
        np.arange(i * n // s, (i + 1) * n // s), k, replace=False))
        for _ in range(q)]) for i in range(s)]).astype(np.int32)
    vals[0, 0, -2:], idx[0, 0, -2:] = rf.BIG, n
    v0, i0 = jax_merge(jnp.asarray(vals), jnp.asarray(idx), k)
    v1, i1 = lexsort_topk_merge(_t(vals), _t(idx), k)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))
    np.testing.assert_array_equal(v1.numpy(), np.asarray(v0))


# -------------------------------------------------------------------- K1

def _jax_k1(queries, gal, pos, **kw):
    out = jax_pallas.retrieve_fused_sharded(
        jnp.asarray(queries), jnp.asarray(gal), jnp.asarray(pos),
        _jax_mesh8(), k=10, tile_q=8, tile_n=128, interpret=True, **kw)
    return [np.asarray(o) for o in out]


def _assert_k1_same(got, want, queries, gal, metric):
    r1, v1, i1 = (t.numpy() for t in got)
    r0, v0, i0 = want
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(r1, r0)
    atol = 1e-6 if metric == "cosine" else RTOL * float(
        np.max(np.sum(queries ** 2, 1)) + np.max(np.sum(gal ** 2, 1)))
    np.testing.assert_allclose(v1, v0, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_fused_sharded_matches_jax(rng, metric):
    n, q, d = 1024, 24, 32  # 128 rows a shard
    gal = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    pos = rng.integers(0, n, size=q).astype(np.int32)
    pos[:3] = [0, n - 1, 128]  # at shard edges
    want = _jax_k1(queries, gal, pos, metric=metric)
    got = rf.retrieve_fused_sharded(_t(queries), _t(gal), _t(pos), _mesh(),
                                    k=10, metric=metric)
    _assert_k1_same(got, want, queries, gal, metric)


def test_fused_sharded_cross_shard_ties(rng):
    """Copies of each row in every shard tie exactly: the smallest global
    index first, and the positive's earlier copies in other shards count
    toward its rank."""
    d = 16
    base = rng.standard_normal((128, d)).astype(np.float32)
    gal = np.concatenate([base] * 8)
    queries = base[[3, 50, 99]] + 0.01 * rng.standard_normal(
        (3, d)).astype(np.float32)
    pos = np.array([3, 128 + 50, 7 * 128 + 99], np.int32)
    want = _jax_k1(queries, gal, pos)
    got = rf.retrieve_fused_sharded(_t(queries), _t(gal), _t(pos), _mesh(),
                                    k=10)
    _assert_k1_same(got, want, queries, gal, "euclidean")
    assert got[0].tolist() == [0, 1, 7]
    assert got[2][0, :8].tolist() == [3 + 128 * s for s in range(8)]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("with_ranks", [True, False])
def test_fused_sharded_equals_unsharded(rng, precision, metric, with_ranks):
    """On the CPU the sharded plain version equals the unsharded one bit
    for bit, in both forms; positives before, in and past every shard
    (-1 and N clamp as the unsharded sweep clamps them)."""
    n, q, d = 256, 21, 24
    gal = rng.standard_normal((n, d)).astype(np.float32)
    gal[200:210] = gal[:10]  # copies in another shard
    pos = rng.integers(0, n, size=q).astype(np.int32)
    pos[:4] = [-1, n, 5, 205]
    queries = (gal[np.clip(pos, 0, n - 1)] + 0.1 * rng.standard_normal(
        (q, d)).astype(np.float32))
    kw = dict(k=12, precision=precision, metric=metric,
              with_ranks=with_ranks)
    want = rf.retrieve_fused(_t(queries), _t(gal), _t(pos), **kw)
    got = rf.retrieve_fused_sharded(_t(queries), _t(gal), _t(pos), _mesh(),
                                    **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # shards placed by the caller, norms computed on each shard
    shards = port_mesh.shard_rows(_t(gal), _mesh())
    again = rf.retrieve_fused_sharded(_t(queries), shards, _t(pos), _mesh(),
                                      **kw)
    np.testing.assert_array_equal(again[2].numpy(), want[2].numpy())


def test_fused_sharded_guards_match_jax(rng):
    gal = rng.standard_normal((1003, 16)).astype(np.float32)  # 1003 % 8
    q, p = np.zeros((4, 16), np.float32), np.zeros(4, np.int32)
    for call in (lambda: _jax_k1(q, gal, p),
                 lambda: rf.retrieve_fused_sharded(_t(q), _t(gal), _t(p),
                                                   _mesh())):
        with pytest.raises(ValueError, match="must be divisible by the "
                                             "'data' mesh axis"):
            call()
    gal = gal[:1024 - 21]
    gal = np.concatenate([gal, gal[:21]])
    for call in (lambda: jax_pallas.retrieve_fused_sharded(
            jnp.asarray(q), jnp.asarray(gal), jnp.asarray(p), _jax_mesh8(),
            k=200, interpret=True),
            lambda: rf.retrieve_fused_sharded(_t(q), _t(gal), _t(p), _mesh(),
                                              k=200)):
        with pytest.raises(ValueError, match="per-shard gallery size 128"):
            call()


@pytest.mark.parametrize("device_get", [False, True])
def test_fused_sharded_certificate_fallback(rng, monkeypatch, device_get):
    """Rows a device's sweep over its shards flags are recomputed over the
    whole gallery and counted in the form's fallback_rows."""
    n, q, d = 64, 6, 16
    gal = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    pos = rng.integers(0, n, size=q).astype(np.int32)
    want = rf.retrieve_fused(_t(queries), _t(gal), _t(pos), k=5)
    sweep = rf.sweep_shards

    def flag_rows_1_4(*a, **kw):
        r, v, i, e = sweep(*a, **kw)
        e = e.clone()
        e[[1, 4]] = 0
        return r, v, i, e

    monkeypatch.setattr(rf, "sweep_shards", flag_rows_1_4)
    before = rf.counters.fallback_rows
    got = rf.retrieve_fused_sharded(_t(queries), _t(gal), _t(pos),
                                    _mesh(4), k=5, device_get=device_get)
    assert rf.counters.fallback_rows - before == 2
    np.testing.assert_array_equal(np.asarray(got[2]), want[2].numpy())
    np.testing.assert_array_equal(np.asarray(got[0]), want[0].numpy())
    np.testing.assert_allclose(np.asarray(got[1]), want[1].numpy(),
                               rtol=1e-6)


# ------------------------------------------------------------- int8 / K2

def _assert_quant_same(got, want, metric):
    v1, i1 = (t.numpy() for t in got)
    v0, i0 = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(v1, v0, rtol=1e-6,
                               atol=1e-6 if metric == "cosine" else 0.0)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_quantized_sharded_matches_jax(rng, metric):
    """Flat random data, where the sharded candidate sets differ from the
    single-device ones: JAX's plain per-shard route."""
    n, d, q, k = 1024, 64, 24, 5
    gal = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    want = jq.retrieve_quantized_sharded(
        jnp.asarray(qs), jq.quantize_gallery(jnp.asarray(gal), metric),
        jnp.asarray(gal), _jax_mesh8(), k=k, rerank_factor=3,
        use_kernel=False)
    qg = pq.quantize_gallery(_t(gal), metric)
    got = pq.retrieve_quantized_sharded(_t(qs), qg, _t(gal), _mesh(), k=k,
                                        rerank_factor=3)
    _assert_quant_same(got, want, metric)


def test_quantized_sharded_matches_jax_k2_interpret(rng):
    """JAX's route with K2 per shard (interpret mode) against the port's
    with ``use_kernel=True`` (its plain version on the CPU)."""
    n, d, q, k = 1024, 32, 12, 4
    gal = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    want = jq.retrieve_quantized_sharded(
        jnp.asarray(qs), jq.quantize_gallery(jnp.asarray(gal)),
        jnp.asarray(gal), _jax_mesh8(), k=k, interpret=True,
        use_kernel=True)
    before = qf.counters.fallback_rows
    got = pq.retrieve_quantized_sharded(_t(qs), pq.quantize_gallery(_t(gal)),
                                        _t(gal), _mesh(), k=k,
                                        use_kernel=True)
    assert qf.counters.fallback_rows == before
    _assert_quant_same(got, want, "euclidean")


def test_quantized_sharded_matches_pershard_oracle(rng):
    """"Per-shard top-r by the approximate score (the earlier index wins
    ties) + local exact rerank + (value, index) merge", in numpy."""
    n, d, q, k, factor, s = 1024, 32, 16, 4, 3, 8
    nl, r = n // s, factor * k
    gal = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    qg = pq.quantize_gallery(_t(gal))
    v1, i1 = pq.retrieve_quantized_sharded(_t(qs), qg, _t(gal), _mesh(s),
                                           k=k, rerank_factor=factor)
    q8, s_q = pq._symmetric_quantize(_t(qs))
    dot = (q8.numpy().astype(np.int64) @ qg.q8.numpy().astype(np.int64).T
           ).astype(np.float32) * (s_q.numpy()[:, None]
                                   * qg.scale.numpy()[None, :])
    approx = qg.sq_norm.numpy()[None, :] - 2.0 * dot
    cand = np.concatenate([np.argsort(approx[:, i * nl:(i + 1) * nl], 1,
                                      kind="stable")[:, :r] + i * nl
                           for i in range(s)], axis=1)
    exact = euclidean_distance(_t(qs)[:, None, :], _t(gal)[cand]).numpy()
    order = [np.lexsort((cand[row], exact[row]))[:k] for row in range(q)]
    np.testing.assert_array_equal(
        i1.numpy(), np.stack([cand[row][o] for row, o in enumerate(order)]))
    np.testing.assert_array_equal(
        v1.numpy(), np.stack([exact[row][o] for row, o in enumerate(order)]))


def test_quantized_sharded_guards_match_jax(rng):
    gal = rng.standard_normal((1020, 32)).astype(np.float32)
    qs = gal[:4]
    for call in (
            lambda: jq.retrieve_quantized_sharded(
                jnp.asarray(qs), jq.quantize_gallery(jnp.asarray(gal)),
                jnp.asarray(gal), _jax_mesh8(), k=4),
            lambda: pq.retrieve_quantized_sharded(
                _t(qs), pq.quantize_gallery(_t(gal)), _t(gal), _mesh(),
                k=4)):
        with pytest.raises(ValueError, match="divisible by"):
            call()
    gal = gal[:16]
    for call in (
            lambda: jq.retrieve_quantized_sharded(
                jnp.asarray(qs), jq.quantize_gallery(jnp.asarray(gal)),
                jnp.asarray(gal), _jax_mesh8(), k=4),
            lambda: pq.retrieve_quantized_sharded(
                _t(qs), pq.quantize_gallery(_t(gal)), _t(gal), _mesh(),
                k=4)):
        with pytest.raises(ValueError, match="per-shard gallery size 2"):
            call()


# ------------------------------------------------------------ evaluation

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_evaluate_retrieval_mesh_matches_jax(rng, monkeypatch, metric):
    """K1 over 8 shards in both packages (threshold lowered; JAX's kernel in
    interpret mode); a gallery of 303 rows, not divisible by 8, takes the
    unsharded K1 in both."""
    for name in ("retrieve_fused", "retrieve_fused_sharded"):
        def interpret(*args, _orig=getattr(jax_pallas, name), **kw):
            kw.update(interpret=True, tile_q=8, tile_n=128)
            return _orig(*args, **kw)

        monkeypatch.setattr(jax_pallas, name, interpret)
    monkeypatch.setattr(jax_rank, "FUSED_GALLERY_THRESHOLD", 100)
    monkeypatch.setattr(port_rank, "FUSED_GALLERY_THRESHOLD", 100)
    for n, route in ((1024, "K1_sharded"), (303, "K1")):
        queries, gal, sketch_paths, image_paths = _features(rng, n=n, q=40)
        want = jax_rank.evaluate_retrieval(queries, gal, sketch_paths,
                                           image_paths, loss_type=metric,
                                           mesh=_jax_mesh8())
        trace = {}
        got = port_rank.evaluate_retrieval(queries, gal, sketch_paths,
                                           image_paths, loss_type=metric,
                                           query_chunk=16, mesh=_mesh(),
                                           trace=trace)
        assert trace["route"] == route
        assert_same_inference_dict(got, want, metric, queries, gal,
                                   sketch_paths, image_paths)
        alone = port_rank.evaluate_retrieval(queries, gal, sketch_paths,
                                             image_paths, loss_type=metric,
                                             query_chunk=16, device="cpu")
        for key in set(got) - {"inference_time"}:
            assert got[key] == alone[key], key


def test_embed_batched_over_a_mesh(rng, monkeypatch):
    """Each batch split over the mesh's distinct devices, the parts'
    outputs in order on the first: the unsplit embedding, bit for bit. A
    device named several times takes one part (the shards of one card)."""
    imgs = rng.integers(0, 255, size=(37, S, S, 3)).astype(np.uint8)
    seen = []

    def forward(x):
        seen.append(x.shape[0])
        return _port_forward(x)

    want = port_embed.embed_batched(_port_forward, imgs, device="cpu")
    got = port_embed.embed_batched(forward, imgs, mesh=_mesh(3))
    np.testing.assert_array_equal(got, want)
    assert seen == [64]
    # three distinct devices, stood in for by three CPU device objects
    monkeypatch.setattr(port_mesh.Mesh, "distinct_devices",
                        lambda self: list(self.devices))
    seen.clear()
    got = port_embed.embed_batched(forward, imgs, mesh=_mesh(3))
    np.testing.assert_array_equal(got, want)
    assert seen == [22, 21, 21]  # one batch of 64 split three ways


# --------------------------------------------------------------- serving

def _engines(data, mesh, **kw):  # noqa: F811
    _, _, feats, paths = data
    kw = dict(image_size=S, max_batch=8, **{"k_max": 5, **kw})
    return (RetrievalEngine(_port_forward, feats, paths, device="cpu", **kw),
            RetrievalEngine(_port_forward, feats, paths, mesh=mesh, **kw))


def _same_search(one, sharded, batch):
    v0, i0 = one.search_arrays(batch)
    v1, i1 = sharded.search_arrays(batch)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(v1, v0, rtol=RTOL, atol=1e-6)
    return i1


@pytest.mark.parametrize("route", ["exact", "K1", "int8", "K2"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_engine_mesh_matches_unsharded(data, monkeypatch, route, metric):
    """40 rows over 8 shards: each route against the unsharded engine."""
    _, queries, _, _ = data
    if route == "K1":
        monkeypatch.setattr(port_rank, "FUSED_GALLERY_THRESHOLD", 1)
    if route == "K2":  # its plain version on the CPU
        monkeypatch.setattr(qf, "kernel_takes", lambda *a: True)
    kw = dict(metric=metric, quantize=route in ("int8", "K2"))
    one, sharded = _engines(data, _mesh(), **kw)
    assert one.route == sharded.route == route
    assert sharded.health_stats()["shards"] == 8
    i = _same_search(one, sharded, queries[[3, 11, 30]])
    assert list(i[:, 0]) == [3, 11, 30]
    _same_search(one, sharded, queries[:8])


def test_engine_mesh_bf16_rerank_rows(data):
    _, queries, _, _ = data
    one, sharded = _engines(data, _mesh(4), quantize=True,
                            rerank_dtype="bfloat16")
    assert all(g.dtype == torch.bfloat16 for g in sharded.gallery)
    _same_search(one, sharded, queries[[3, 8]])


def test_engine_mesh_capacity_add_remove(data):
    """Capacity 8 over 2 shards (slot s in shard s // 4): adds, removals
    and reused slots as the unsharded engine makes them."""
    imgs, queries, feats, _ = data
    kw = dict(image_size=S, k_max=4, max_batch=8, capacity=8)
    paths = ["gallery/img_0.png", "gallery/img_1.png"]
    one = RetrievalEngine(_port_forward, feats[:2], paths, device="cpu",
                          **kw)
    sharded = RetrievalEngine(_port_forward, feats[:2], paths,
                              mesh=_mesh(2), **kw)
    items = [(_png(imgs[i]), f"added/img_{i}.png") for i in (5, 6, 7)]
    assert one.add_images(items) == sharded.add_images(items) == [2, 3, 4]
    assert sharded.gallery[1][0].equal(one.gallery[4])  # slot 4: shard 1
    _same_search(one, sharded, queries[[6, 1, 7]])
    assert one.remove(["added/img_6.png"]) == [3]
    assert sharded.remove(["added/img_6.png"]) == [3]
    _same_search(one, sharded, queries[[6, 1]])
    item = [(_png(imgs[9]), "added/img_9.png")]
    assert one.add_images(item) == sharded.add_images(item) == [3]
    _same_search(one, sharded, queries[[9, 5, 1]])
    assert sharded.image_paths == one.image_paths
    assert sharded.n_valid == one.n_valid == 5


def test_engine_mesh_guards(data):
    _, _, feats, paths = data
    with pytest.raises(ValueError, match="divisible by the mesh"):
        RetrievalEngine(_port_forward, feats[:30], paths[:30], mesh=_mesh())
    with pytest.raises(ValueError, match="divisible by the mesh"):
        RetrievalEngine(_port_forward, feats, paths, capacity=44,
                        mesh=_mesh())
    with pytest.raises(ValueError, match="per-shard gallery size 5"):
        RetrievalEngine(_port_forward, feats, paths, k_max=6, mesh=_mesh())
    with pytest.raises(ValueError, match="does not compose with quantize"):
        RetrievalEngine(_port_forward, feats, paths, k_max=5, ivf_nlist=4,
                        quantize=True, mesh=_mesh())
    with pytest.raises(ValueError, match="immutable indexes only"):
        RetrievalEngine(_port_forward, feats, paths, k_max=5, ivf_nlist=4,
                        pq_m=4, capacity=48, mesh=_mesh())


def test_serve_cli_n_devices(tmp_path):
    """``--n_devices 2 --device cpu`` shards the served rows; a mesh passed
    to ``build_engine`` takes the flag's place."""
    from tests.test_torch_serve import _served_run

    args = port_serve.parse_args([
        "-f", "ModifiedResNet_Tiny_2026", "--device", "cpu"])
    assert args.n_devices == 1
    run = _served_run(tmp_path, n=12, capacity=None, n_devices=2)
    engine, batcher = port_serve.build_engine(run)
    batcher.close()
    assert engine.health_stats()["shards"] == 2
    assert [g.shape[0] for g in engine.gallery] == [6, 6]
    engine, batcher = port_serve.build_engine(run, mesh=_mesh(4))
    batcher.close()
    assert engine.n_shards == 4


# ------------------------------------------------------------------- CLI

def test_inference_cli_n_devices_matches_one_device(tmp_path):
    """``cli/inference.py --n_devices 2 --device cpu`` (batches split over
    two CPU shards, the gallery sharded on K1's route with the threshold
    lowered) writes the dict of ``--n_devices 1``."""
    root = make_synthetic_sketchy(tmp_path / "sketchy", n_classes=20,
                                  photos_per_class=10, sketches_per_photo=1)
    args = _results_folder(tmp_path, root)
    out = {}
    saved = port_rank.FUSED_GALLERY_THRESHOLD
    port_rank.FUSED_GALLERY_THRESHOLD = 1
    try:
        for n in ("1", "2"):
            port_cli.main(args + ["--device", "cpu", "--n_devices", n])
            out[n] = json.loads((tmp_path / "results" / RUN
                                 / "inference_updated.json").read_text())
    finally:
        port_rank.FUSED_GALLERY_THRESHOLD = saved
    samples = {}
    for n, d in out.items():
        d.pop("inference_time")
        d.pop("image_features")
        samples[n] = d.pop("retrieval_samples")
    assert out["2"] == out["1"]
    # the sample paths exact; their distances from embeddings of split
    # batches, whose convolutions may round differently
    for a, b in zip(samples["2"], samples["1"]):
        assert list(a) == list(b)
        (ea,), (eb,) = a.values(), b.values()
        assert [p for p, _ in ea] == [p for p, _ in eb]
        np.testing.assert_allclose([v for _, v in ea], [v for _, v in eb],
                                   rtol=RTOL)
    # so the gallery was sharded (k = 10 rows a shard at least)
    assert out["1"]["size"] % 2 == 0 and out["1"]["size"] >= 20


def test_probe_sharded_cards_on_cpu_shards(capsys):
    """The distinct-cards probe's control flow on 4 CPU shards: its bit
    checks pass and it prints one line of times a gallery size."""
    from art_sbir_tpu_torch.scripts import probe_sharded_cards

    assert probe_sharded_cards.main(["2048", "--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    out = json.loads(line)
    assert out["n"] == 2048 and out["shards"] == 4
    assert out["k1_bit_equal_cases"] == 4
    assert [t["q"] for t in out["k1_times"]] == [32, 1024]
    assert set(out["int8_route"]) == {"unsharded_ms", "sharded_ms"}


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_cuda_sharded_k1_equals_unsharded(rng):
    """On the card: K1 over 4 shards of one card equals unsharded K1 bit
    for bit, in both forms, copies of rows across shards included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run by chip_smoke.py)")
    n, q, d = 4096, 37, 64
    gal = rng.standard_normal((n, d)).astype(np.float32)
    gal[3000:3010] = gal[:10]
    pos = rng.integers(0, n, size=q).astype(np.int32)
    pos[:3] = [5, 3005, n - 1]
    queries = gal[pos] + 0.1 * rng.standard_normal((q, d)).astype(np.float32)
    dev = torch.device("cuda")
    mesh = port_mesh.MeshSpec(4).build([dev] * 4)
    args = [torch.from_numpy(a).to(dev) for a in (queries, gal, pos)]
    for precision in ("highest", "default"):
        want = rf.retrieve_fused(*args, k=10, precision=precision)
        got = rf.retrieve_fused_sharded(*args, mesh, k=10,
                                        precision=precision)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
