"""The port's IVF index (``art_sbir_tpu_torch/ops/ivf.py``) against the
JAX package's (``art_sbir_tpu/ops/ivf.py``), on the CPU.

The random streams differ (JAX's ``jax.random`` against torch
generators), so builds are held by their steps and their quality, and
searches exact on one shared index: JAX builds it, ``save_ivf`` writes
it and the port's ``load_ivf`` reads it. Precision: the port's
``precision='default'`` rounds the cross term's operands to bf16 (the
TPU's behaviour) where JAX on the CPU computes in float32, so wherever a
result passes an argmin or a probe, the inputs make the winner lead by
far more than the bf16 error (separated blobs), and the shared index's
centroids and the queries are rounded to bf16 (the port's rounding is
then a no-op). Tolerances:

* ``_kmeans_step``: centroids at rtol 1e-5 (float32 sums in another
  order); ``_assign``, ``pack_table``: equal.
* searches on a shared index: indices equal, values at rtol 1e-5
  (atol 1e-6; the row-wise float32 sums in another order), ``+inf`` pads
  in the same places.
* ``tune_nprobe``: the same nprobe. ``OnlineIVF``: the same tables, spill,
  stats and results after every step.
* sharded: the port on ``[cpu] * 8`` against JAX on its 8 virtual CPU
  devices, as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.ops import ivf as J
from art_sbir_tpu.parallel import mesh as jax_mesh
from art_sbir_tpu_torch.ops import ivf as T
from art_sbir_tpu_torch.ops.distance import (cosine_distance,
                                             euclidean_distance,
                                             pairwise_distance, retrieve,
                                             top_k)
from art_sbir_tpu_torch.ops.quant import topk_overlap
from art_sbir_tpu_torch.parallel import mesh as port_mesh
from tests.torch_threads import two_torch_threads  # noqa: F401


CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16 values (kept float32)."""
    return _t(x).bfloat16().float().numpy()


def _blobs(rng, n_per, centers, d, scale=0.05):
    """Separated gaussian blobs -> (rows, labels), shuffled; ``n_per``
    rows a blob, or a sequence of blob sizes."""
    sizes = [n_per] * len(centers) if np.isscalar(n_per) else n_per
    rows, labels = [], []
    for i, (c, size) in enumerate(zip(centers, sizes)):
        rows.append(c + scale * rng.standard_normal((size, d)))
        labels += [i] * size
    x = np.concatenate(rows).astype(np.float32)
    perm = rng.permutation(len(x))
    return x[perm], np.asarray(labels)[perm]


def _same(got, want):
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)


def _exact(q, g, k, metric="euclidean"):
    """The exact route's indices and their row-wise distances (the
    pairwise form cancels at near-zero distances; the probe scores
    row-wise)."""
    q, g = _t(q), _t(g)
    _, _, ei = retrieve(q, g, torch.zeros(len(q), dtype=torch.int32), k=k,
                        metric=metric)
    row = euclidean_distance if metric == "euclidean" else cosine_distance
    return row(q[:, None], g[ei.long()]), ei


def _shared(tmp_path, g, nlist, metric="euclidean", name="ivf.npz", **kw):
    """(JAX index, port index): built by JAX, centroids rounded to bf16,
    written by JAX's ``save_ivf`` and read by the port's ``load_ivf``."""
    ji = J.build_ivf(jnp.asarray(g), nlist, metric=metric, **kw)
    ji = ji._replace(centroids=jnp.asarray(_bf16(np.asarray(ji.centroids))))
    J.save_ivf(ji, tmp_path / name)
    return ji, T.load_ivf(tmp_path / name, device="cpu")


def _clustered(seed=3, n_blobs=12, d=24, nq=10):
    """Blobs of 10 to 21 rows (uneven clusters: padded slots)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_blobs, d)) * 4.0
    g, _ = _blobs(rng, range(10, 10 + n_blobs), centers, d, scale=0.3)
    q = _bf16(g[rng.integers(0, len(g), nq)]
              + 0.05 * rng.standard_normal((nq, d)).astype(np.float32))
    return g, q


# ------------------------------------------------------------------- build

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_kmeans_step_and_assign_match_jax(metric):
    """One Lloyd's step and the assignment from fed centroids."""
    rng = np.random.default_rng(0)
    d, c = 16, 5
    centers = rng.standard_normal((c, d)) * 5.0
    x, labels = _blobs(rng, 30, centers, d)
    cent = (centers + 0.3 * rng.standard_normal((c, d))).astype(np.float32)
    spherical = metric == "cosine"
    if spherical:
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        cent = cent / np.linalg.norm(cent, axis=1, keepdims=True)
    chunk = 64  # 150 rows: two full chunks and a padded one
    jx, jw, _ = J._pad_rows(jnp.asarray(x), chunk)
    tx, tw, _ = T._pad_rows(_t(x), chunk)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    want = J._kmeans_step(jx, jw, jnp.asarray(cent), chunk=chunk,
                          spherical=spherical)
    got = T._kmeans_step(tx, tw, _t(cent), chunk=chunk, spherical=spherical)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    want_l = np.asarray(J._assign(jx, jnp.asarray(cent), chunk=chunk))
    got_l = T._assign(_t(x), _t(cent), chunk=chunk).numpy()  # unpadded
    np.testing.assert_array_equal(got_l, want_l[:len(x)])
    assert (got_l == labels).all() or len(set(zip(got_l, labels))) == c


def test_kmeanspp_and_kmeans_recover_separated_blobs():
    """tests/test_ops_ivf.py's contract for the port's k-means: every true
    center has a centroid within the blob scale, none collapse."""
    rng = np.random.default_rng(0)
    d = 16
    centers = rng.standard_normal((4, d)) * 5.0
    x, _ = _blobs(rng, 50, centers, d)
    init = T._kmeanspp_init(_t(x), T._generator(3, "cpu"), c=4).numpy()
    assert len({tuple(r) for r in init}) == 4  # distinct rows of x
    assert all((np.abs(x - r).sum(1) == 0).any() for r in init)
    cent = T.kmeans(_t(x), 4, iters=15, seed=3).numpy()
    dist = np.linalg.norm(centers[:, None] - cent[None], axis=-1)
    assert dist.min(axis=1).max() < 0.5
    assert len(set(dist.argmin(axis=1))) == 4
    again = T.kmeans(_t(x), 4, iters=15, seed=3).numpy()
    np.testing.assert_array_equal(cent, again)  # deterministic on a device


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_build_ivf_recovers_blobs_like_jax(metric):
    """Both builds put each blob in one cluster of its own; the sample
    path (N > sample) too."""
    rng = np.random.default_rng(1)
    d = 16
    centers = rng.standard_normal((6, d)) * 5.0
    g, labels = _blobs(rng, 20, centers, d, scale=0.05)
    for sample in (131072, 60):
        for idx in (J.build_ivf(jnp.asarray(g), 6, metric=metric, iters=8,
                                sample=sample),
                    T.build_ivf(_t(g), 6, metric=metric, iters=8,
                                sample=sample)):
            table = np.asarray(idx.row_ids)
            assert idx.stats()["nlist"] == 6
            for c in range(6):
                rows = table[c][table[c] < len(g)]
                assert len(set(labels[rows])) <= 1
            assert sorted(idx.counts.tolist()) == [20] * 6


def test_pack_table_matches_jax():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 7, 150).astype(np.int32)
    labels[labels == 3] = 4  # an empty cluster
    for n_clusters in (7, 9):
        want = J.pack_table(labels, n_clusters, 150)
        got = T.pack_table(labels, n_clusters, 150)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype


def test_build_validation_and_edges_match_jax():
    g = torch.zeros((4, 8))
    for fn, arr in ((J.build_ivf, jnp.asarray(g.numpy())), (T.build_ivf, g)):
        with pytest.raises(ValueError, match="n_clusters"):
            fn(arr, 5)
        with pytest.raises(ValueError, match="empty gallery"):
            fn(arr[:0], 1)
        with pytest.raises(ValueError, match="unknown metric"):
            fn(arr, 2, metric="dot")
    idx = T.build_ivf(g + torch.arange(4.0)[:, None], 2, iters=2)
    with pytest.raises(ValueError, match="nprobe"):
        T.ivf_search(torch.zeros((1, 8)), idx, g, nprobe=0)
    v, i = T.ivf_search(torch.zeros((0, 8)), idx, g, nprobe=2, k=3)
    assert v.shape == (0, 3) and i.shape == (0, 3) and i.dtype == torch.int32


# ------------------------------------------------------------------ search

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_full_probe_equals_exact_route(metric):
    """The port's own build: ``nprobe == nlist`` equals ``retrieve``,
    duplicates' tie order included (tests/test_ops_ivf.py's contract)."""
    rng = np.random.default_rng(1)
    g = rng.standard_normal((200, 32)).astype(np.float32)
    g = np.concatenate([g, g[:13]])
    q = rng.standard_normal((16, 32)).astype(np.float32)
    idx = T.build_ivf(_t(g), 8, metric=metric, iters=5)
    got = T.ivf_search(_t(q), idx, _t(g), nprobe=idx.nlist, k=7)
    _same(got, _exact(q, g, 7, metric))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("case", ["nprobe1", "full", "k_past", "bf16",
                                  "chunks", "mask_spill"])
def test_ivf_search_matches_jax_on_shared_index(tmp_path, metric, case):
    g, q = _clustered()
    n = len(g)
    ji, ti = _shared(tmp_path, g, 12, metric, iters=8)
    kw = dict(nprobe=1, k=5)
    jg, tg = jnp.asarray(g), _t(g)
    jkw, tkw = {}, {}
    if case == "full":
        kw["nprobe"] = 12
    elif case == "k_past":  # past the probed cluster's rows: +inf pads
        kw["k"] = 40
    elif case == "bf16":
        jg, tg = jg.astype(jnp.bfloat16), tg.bfloat16()
        kw["nprobe"] = 2
    elif case == "chunks":
        kw.update(nprobe=3, row_budget_bytes=1)
    elif case == "mask_spill":
        rng = np.random.default_rng(4)
        mask = rng.random(n) < 0.7
        spill = np.full(16, n, np.int32)
        spill[:5] = rng.choice(n, 5, replace=False)
        jkw = dict(mask=jnp.asarray(mask), spill=jnp.asarray(spill))
        tkw = dict(mask=_t(mask), spill=_t(spill))
        kw["nprobe"] = 2
    want = J.ivf_search(jnp.asarray(q), ji, jg, **kw, **jkw)
    got = T.ivf_search(_t(q), ti, tg, **kw, **tkw)
    _same(got, want)
    if case == "k_past":
        assert not np.isfinite(got[0].numpy()).all()
        assert (got[1].numpy()[~np.isfinite(got[0].numpy())] == n).all()


def test_tune_nprobe_and_margin_match_jax(tmp_path):
    g, q = _clustered(seed=7, nq=32)
    ji, ti = _shared(tmp_path, g, 12, iters=8)
    for target in (0.8, 0.95, 1.0):
        for margin in (1, 2, 100):
            want = J.tune_nprobe(ji, jnp.asarray(g), jnp.asarray(q), k=10,
                                 target_recall=target, margin=margin)
            got = T.tune_nprobe(ti, _t(g), _t(q), k=10,
                                target_recall=target, margin=margin)
            assert got == want, (target, margin)
    assert T.SERVING_NPROBE_MARGIN == J.SERVING_NPROBE_MARGIN == 2
    for args in ((1, 16), (4, 16), (8, 16), (3, 5, 1), (2, 7, 3)):
        assert T.apply_nprobe_margin(*args) == J.apply_nprobe_margin(*args)
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="target_recall"):
            T.tune_nprobe(ti, _t(g), _t(q), target_recall=bad)
    with pytest.raises(ValueError, match="margin"):
        T.tune_nprobe(ti, _t(g), _t(q), margin=0)


def test_recall_on_clustered_data_monotone_in_nprobe():
    rng = np.random.default_rng(3)
    d = 24
    centers = rng.standard_normal((16, d)) * 4.0
    g, _ = _blobs(rng, 64, centers, d, scale=0.3)
    q = g[rng.integers(0, len(g), 32)] + 0.05 * rng.standard_normal(
        (32, d)).astype(np.float32)
    idx = T.build_ivf(_t(g), 16, iters=10)
    _, _, exact = retrieve(_t(q), _t(g), torch.zeros(32, dtype=torch.int32),
                           k=10)
    recalls = [topk_overlap(T.ivf_search(_t(q), idx, _t(g), nprobe=p,
                                         k=10)[1], exact)
               for p in (1, 2, 4, 16)]
    assert recalls[0] > 0.8 and recalls[-1] == 1.0
    assert all(b >= a - 1e-9 for a, b in zip(recalls, recalls[1:]))


# -------------------------------------------------------------- online IVF

def _online_pair(tmp_path, buf, n0, nlist, **kw):
    """(JAX OnlineIVF, port OnlineIVF) over one shared index of the first
    ``n0`` rows."""
    ji, ti = _shared(tmp_path, buf[:n0], nlist, iters=8)
    cap = len(buf)
    return (J.OnlineIVF(ji, n0, cap, **kw), T.OnlineIVF(ti, n0, cap, **kw))


def _same_online(jo, to, buf, mask, q, nprobes):
    np.testing.assert_array_equal(to.row_ids.numpy(), np.asarray(jo.row_ids))
    np.testing.assert_array_equal(to.spill.numpy(), np.asarray(jo.spill))
    assert to.stats() == jo.stats()
    for nprobe in nprobes:
        want = jo.search(jnp.asarray(q), jnp.asarray(buf), nprobe=nprobe,
                         k=6, mask=jnp.asarray(mask))
        got = to.search(_t(q), _t(buf), nprobe=nprobe, k=6, mask=_t(mask))
        _same(got, want)


def _masked_exact(q, buf, mask, k):
    d = pairwise_distance(_t(q), _t(buf))
    return top_k(d, k, valid=_t(mask))


def test_online_ivf_churn_matches_jax_step_for_step(tmp_path):
    """tests/test_ops_ivf.py's churn (adds, removals of initial and added
    rows, a freed slot reused) on blob rows: after every step the port's
    table, spill, stats and searches equal JAX's, and full probe equals
    the masked exact route."""
    rng = np.random.default_rng(10)
    d, cap, n0 = 16, 64, 24
    centers = rng.standard_normal((4, d)) * 4.0
    rows, _ = _blobs(rng, 10, centers, d, scale=0.3)
    buf = np.zeros((cap, d), np.float32)
    buf[:n0] = rows[:n0]
    jo, to = _online_pair(tmp_path, buf, n0, 4)
    mask = np.zeros(cap, bool)
    mask[:n0] = True
    q = _bf16(rows[rng.integers(0, 40, 8)] + 0.01)

    def check():
        _same_online(jo, to, buf, mask, q, (1, 4))
        got = to.search(_t(q), _t(buf), nprobe=4, k=6, mask=_t(mask))
        ev, ei = _masked_exact(q, buf, mask, 6)
        np.testing.assert_array_equal(got[1].numpy(), ei.numpy())

    check()
    new = rows[n0:40]
    buf[24:40], mask[24:40] = new, True
    jo.add(list(range(24, 40)), jnp.asarray(new))
    to.add(list(range(24, 40)), _t(new))
    check()
    for r in (3, 30, 25):
        mask[r] = False
        jo.remove(r)
        to.remove(r)
        check()
    buf[3] = centers[1] + 0.1
    mask[3] = True
    jo.add([3], jnp.asarray(buf[3][None]))
    to.add([3], _t(buf[3][None]))
    check()
    assert to.stats()["live_rows"] == n0 + 16 - 3 + 1
    assert to.stats()["repacks"] == 0


def test_online_ivf_spill_then_repack_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    d, cap = 8, 128
    c0 = np.zeros(d, np.float32)
    c1 = np.full(d, 10.0, np.float32)
    buf = np.zeros((cap, d), np.float32)
    buf[:8] = c0 + 0.1 * rng.standard_normal((8, d))
    buf[8:16] = c1 + 0.1 * rng.standard_normal((8, d))
    mask = np.zeros(cap, bool)
    mask[:16] = True
    jo, to = _online_pair(tmp_path, buf, 16, 2, spill_capacity=8)
    assert to.stats()["pad_width"] == 8  # both clusters born full
    q = _bf16(np.stack([c0 + 0.05, c1 - 0.05]))
    held = (to.row_ids, to.spill)  # a search in flight holds these
    held_np = (held[0].numpy().copy(), held[1].numpy().copy())
    new = (c0 + 0.1 * rng.standard_normal((8, d))).astype(np.float32)
    buf[16:24], mask[16:24] = new, True
    jo.add(list(range(16, 24)), jnp.asarray(new))  # cluster 0 overflows
    to.add(list(range(16, 24)), _t(new))
    assert to.stats()["spill_used"] == 8 and to.stats()["repacks"] == 0
    _same_online(jo, to, buf, mask, q, (1, 2))
    buf[24], mask[24] = c0 + 0.01, True  # the spill is full: repack
    jo.add([24], jnp.asarray(buf[24][None]))
    to.add([24], _t(buf[24][None]))
    st = to.stats()
    assert st["repacks"] == 1 and st["spill_used"] == 0
    assert st["pad_width"] > 8
    _same_online(jo, to, buf, mask, q, (1, 2))
    mask[17] = False  # a spilled-then-repacked row removes cleanly
    jo.remove(17)
    to.remove(17)
    _same_online(jo, to, buf, mask, q, (1, 2))
    # published tensors were never written into
    np.testing.assert_array_equal(held[0].numpy(), held_np[0])
    np.testing.assert_array_equal(held[1].numpy(), held_np[1])


def test_online_ivf_validation_and_build_online():
    rng = np.random.default_rng(13)
    d, cap, n0 = 8, 16, 4
    buf = np.zeros((cap, d), np.float32)
    buf[:n0] = rng.standard_normal((n0, d))
    oiv = T.build_ivf_online(_t(buf), n0, 2, iters=3)
    assert oiv.capacity == cap and oiv.nlist == 2
    rows = rng.standard_normal((4, d)).astype(np.float32)
    oiv.add([n0], _t(rows))  # a padded batch: trailing rows ignored
    assert oiv.stats()["live_rows"] == n0 + 1
    with pytest.raises(ValueError, match="already indexed"):
        oiv.add([n0], _t(rows))
    with pytest.raises(ValueError, match="outside"):
        oiv.add([cap], _t(rows))
    with pytest.raises(ValueError, match="ids vs"):
        oiv.add([1, 2, 3, 4, 5], _t(rows))
    with pytest.raises(KeyError):
        oiv.remove(cap - 1)
    with pytest.raises(ValueError, match=">= 1 initial"):
        T.build_ivf_online(_t(buf), 0, 2)
    oiv.add([], torch.zeros((0, d)))  # no-op


def test_online_search_during_adds_sees_published_states():
    """A search on another thread, racing adds and removals, returns live
    rows of some published state and never raises (the engine's lock
    hands it a consistent (mask, table, spill); here the test does)."""
    import threading

    rng = np.random.default_rng(14)
    d, cap, n0 = 8, 256, 32
    buf = rng.standard_normal((cap, d)).astype(np.float32)
    oiv = T.build_ivf_online(_t(buf), n0, 4, iters=3, spill_capacity=8)
    lock = threading.Lock()
    state = {"mask": _t(np.arange(cap) < n0)}
    errors, seen = [], []
    stop = threading.Event()

    def searcher():
        q = _t(buf[:4] + 0.01)
        while not stop.is_set():
            with lock:
                idx, spill, mask = oiv.as_index(), oiv.spill, state["mask"]
            try:
                _, ids = T.ivf_search(q, idx, _t(buf), nprobe=4, k=5,
                                      mask=mask, spill=spill)
                live = ids.numpy()[ids.numpy() < cap]
                assert mask.numpy()[live].all()
                seen.append(len(live))
            except Exception as e:  # reported below
                errors.append(e)

    th = threading.Thread(target=searcher)
    th.start()
    try:
        for i in range(n0, 160):
            with lock:
                oiv.add([i], _t(buf[i][None]))
                m = state["mask"].clone()
                m[i] = True
                if i % 3 == 0:
                    oiv.remove(i - 10)
                    m[i - 10] = False
                state["mask"] = m
    finally:
        stop.set()
        th.join(timeout=60)
    assert not errors, errors[:1]
    assert seen and oiv.stats()["repacks"] >= 1


# ----------------------------------------------------------------- sharded

def _pmesh(n=8):
    return port_mesh.MeshSpec(n).build([CPU] * n)


def _jmesh():
    return jax_mesh.MeshSpec(data=len(jax.devices())).build()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_sharded_ivf_matches_jax_on_shared_index(tmp_path, metric):
    """JAX's ShardedIVF written by ``save_ivf_sharded``, read by the port's
    ``load_ivf_sharded`` onto ``[cpu] * 8``: nprobe 1 and full probe,
    query chunks, against JAX's sharded search; full probe equals the
    exact route, cross-shard duplicates in index order."""
    s = 8
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((6, 24)) * 4.0
    g, _ = _blobs(rng, 20, centers, 24, scale=0.3)
    g = np.concatenate([g[:120], g[:8]])  # 128 rows, duplicates
    q = _bf16(g[:6] + 0.02)
    js = J.build_ivf_sharded(jnp.asarray(g), s, 3, metric=metric, iters=4)
    js = js._replace(centroids=jnp.asarray(_bf16(np.asarray(js.centroids))))
    J.save_ivf_sharded(js, tmp_path / "s.npz")
    ts = T.load_ivf_sharded(tmp_path / "s.npz", devices=[CPU] * s)
    assert (ts.n_shards, ts.nlist, ts.n_local) == (s, 3, 16)
    assert ts.stats() == js.stats()
    for kw in (dict(nprobe=1, k=5), dict(nprobe=3, k=9),
               dict(nprobe=2, k=5, row_budget_bytes=1)):
        want = J.ivf_search_sharded(jnp.asarray(q), js, jnp.asarray(g),
                                    _jmesh(), **kw)
        got = T.ivf_search_sharded(_t(q), ts, _t(g), _pmesh(), **kw)
        _same(got, want)
    got = T.ivf_search_sharded(_t(q), ts, _t(g), _pmesh(), nprobe=3, k=9)
    _same(got, _exact(q, g, 9, metric))


def test_sharded_build_full_probe_and_guards_match_jax():
    s = 8
    rng = np.random.default_rng(8)
    g = rng.standard_normal((16 * s, 8)).astype(np.float32)
    q = _t(g[:3] + 0.01)
    ts = T.build_ivf_sharded(_t(g), s, 2, iters=3)
    got = T.ivf_search_sharded(q, ts, _t(g), _pmesh(), nprobe=2, k=5)
    _same(got, _exact(q.numpy(), g, 5))
    parts = T.build_ivf_sharded(list(_t(g).chunk(s)), s, 2, iters=3)
    for a, b in zip(parts.row_ids, ts.row_ids):
        assert torch.equal(a, b)  # row shards build as the whole gallery
    with pytest.raises(ValueError, match="divisible"):
        T.build_ivf_sharded(_t(g[:-1]), s, 2)
    with pytest.raises(ValueError, match="nprobe"):
        T.ivf_search_sharded(q, ts, _t(g), _pmesh(), nprobe=0)
    with pytest.raises(ValueError, match="exceeds the per-shard"):
        T.ivf_search_sharded(q, ts, _t(g), _pmesh(), k=17)
    with pytest.raises(ValueError, match="shards"):
        T.ivf_search_sharded(q, ts, _t(g[:8 * s]), _pmesh(), k=2)
    with pytest.raises(ValueError, match="shards"):
        T.ivf_search_sharded(q, ts, _t(g), _pmesh(4), k=2)
    v, i = T.ivf_search_sharded(torch.zeros((0, 8)), ts, _t(g), _pmesh(), k=3)
    assert v.shape == (0, 3) and i.shape == (0, 3)
    tuned = T.tune_nprobe(
        ts, _t(g), q, k=5,
        search_fn=lambda qq, p, kk: T.ivf_search_sharded(
            qq, ts, _t(g), _pmesh(), nprobe=p, k=kk))
    assert 1 <= tuned <= ts.nlist


def test_sharded_online_churn_matches_jax_and_single_device():
    """ShardedOnlineIVF through adds that span shards (trailing shards
    start empty) and removals: full probe equals JAX's sharded online
    index and the masked exact route at every step; the port's sharded
    online index equals its single-device OnlineIVF (same centroids) at
    every nprobe while nothing spills."""
    s = 8
    rng = np.random.default_rng(12)
    d, cap_local, n0 = 16, 16, 24
    cap = s * cap_local
    centers = rng.standard_normal((4, d)) * 5.0
    rows, _ = _blobs(rng, 12, centers, d, scale=0.3)
    buf = np.zeros((cap, d), np.float32)
    buf[:n0] = rows[:n0]
    js = J.build_ivf_sharded_online(jnp.asarray(buf), n0, s, 4, iters=5)
    ts = T.build_ivf_sharded_online(_t(buf), n0, s, 4, iters=5)
    one = T.OnlineIVF(T.IVFIndex(ts.centroids, *_single_table(ts, n0)),
                      n0, cap)
    assert ts.n_shards == s and ts.capacity == cap
    mask = np.zeros(cap, bool)
    mask[:n0] = True
    q = _bf16(rows[rng.integers(0, 48, 8)] + 0.01)

    def check():
        want = js.search(jnp.asarray(q), jnp.asarray(buf), _jmesh(),
                         nprobe=4, k=6, mask=jnp.asarray(mask))
        got = ts.search(_t(q), _t(buf), _pmesh(), nprobe=4, k=6,
                        mask=_t(mask))
        _same(got, want)
        ev, ei = _masked_exact(q, buf, mask, 6)
        np.testing.assert_array_equal(got[1].numpy(), ei.numpy())
        for nprobe in (1, 2):
            _same(ts.search(_t(q), _t(buf), _pmesh(), nprobe=nprobe, k=6,
                            mask=_t(mask)),
                  one.search(_t(q), _t(buf), nprobe=nprobe, k=6,
                             mask=_t(mask)))

    check()
    new = rows[n0:48]
    buf[24:48], mask[24:48] = new, True  # spans shards 1-2
    js.add(list(range(24, 48)), jnp.asarray(new))
    ts.add(list(range(24, 48)), _t(new))
    one.add(list(range(24, 48)), _t(new))
    check()
    for r in (3, 30, 25):
        mask[r] = False
        js.remove(r)
        ts.remove(r)
        one.remove(r)
    check()
    st = ts.stats()
    assert st["live_rows"] == n0 + 24 - 3 and st["spill_used"] == 0
    assert st["n_shards"] == s and st["rows_per_shard"] == cap_local
    with pytest.raises(ValueError, match="outside"):
        ts.add([cap], torch.zeros((1, d)))
    with pytest.raises(KeyError, match="not in the IVF index"):
        ts.remove(cap - 1)


def _single_table(ts, n0):
    """The initial rows' (table, counts) of a sharded online index, as one
    single-device table over global slots (pad sentinel ``n0``)."""
    labels = np.empty(n0, np.int32)
    for s, sh in enumerate(ts.shards):
        tab = sh.row_ids.numpy()
        for c in range(tab.shape[0]):
            for rid in tab[c][tab[c] < ts.cap_local]:
                labels[s * ts.cap_local + rid] = c
    table, counts = T.pack_table(labels, ts.nlist, n0)
    return torch.from_numpy(table), counts, ts.metric


# ------------------------------------------------------------------- files

def test_index_files_round_trip_both_directions(tmp_path):
    """ivf.npz and ivf_sharded.npz: JAX's files load in the port, the
    port's in JAX, with the same keys, dtypes and metric string."""
    rng = np.random.default_rng(15)
    g = rng.standard_normal((64, 16)).astype(np.float32)
    ji = J.build_ivf(jnp.asarray(g), 4, metric="cosine", iters=3)
    J.save_ivf(ji, tmp_path / "j.npz")
    ti = T.load_ivf(tmp_path / "j.npz", device="cpu")
    T.save_ivf(ti, tmp_path / "t.npz")
    back = J.load_ivf(tmp_path / "t.npz")
    for a, b in ((ji, ti), (ji, back)):
        np.testing.assert_array_equal(np.asarray(b.centroids),
                                      np.asarray(a.centroids))
        np.testing.assert_array_equal(np.asarray(b.row_ids),
                                      np.asarray(a.row_ids))
        np.testing.assert_array_equal(b.counts, a.counts)
        assert b.metric == "cosine"
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert all(zj[k].dtype == zt[k].dtype for k in zj.files)
    js = J.build_ivf_sharded(jnp.asarray(g), 8, 2, iters=3)
    J.save_ivf_sharded(js, tmp_path / "js.npz")
    ts = T.load_ivf_sharded(tmp_path / "js.npz", devices="cpu")
    T.save_ivf_sharded(ts, tmp_path / "ts.npz")
    back = J.load_ivf_sharded(tmp_path / "ts.npz")
    assert (back.metric, back.n_local) == (js.metric, js.n_local)
    np.testing.assert_array_equal(np.asarray(back.row_ids),
                                  np.asarray(js.row_ids))
    np.testing.assert_array_equal(np.asarray(back.centroids),
                                  np.asarray(js.centroids))
    np.testing.assert_array_equal(back.counts, js.counts)


@pytest.mark.cuda
def test_cuda_ivf_full_probe_equals_retrieve():
    """On the card: the probe at ``nprobe == nlist`` equals the exact
    route, indices exact, values at rtol 1e-5 (queries apart from every
    row, so the exact route's expanded form does not cancel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(16)
    g = torch.from_numpy(rng.standard_normal((4096, 256)).astype(
        np.float32)).cuda()
    q = torch.from_numpy(rng.standard_normal((32, 256)).astype(
        np.float32)).cuda()
    for metric in ("euclidean", "cosine"):
        idx = T.build_ivf(g, 32, metric=metric, iters=4)
        v, i = T.ivf_search(q, idx, g, nprobe=idx.nlist, k=10)
        _, ev, ei = retrieve(q, g, torch.zeros(32, dtype=torch.int32,
                                               device="cuda"), k=10,
                             metric=metric)
        assert torch.equal(i, ei)
        torch.testing.assert_close(v, ev, rtol=1e-5, atol=1e-6)
