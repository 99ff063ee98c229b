"""The port's IVF and IVF-PQ serving routes (``RetrievalEngine(...,
ivf_nlist=...)`` and ``cli/serve.py``'s flags) against the JAX engine's,
on the CPU: the routes of ``tests/test_serving.py``'s IVF tests.

The engines build their own k-means (the random streams differ), so:

* at full probe (``nprobe == nlist``, and a PQ rerank covering every
  candidate) each route equals the exact engine: the same paths, and the
  distances of ``tests/test_torch_serve.py`` (squared euclidean at rtol
  1e-5 with an absolute floor of 1e-5 x (|q|^2 + |g|^2); cosine at rtol
  1e-5);
* on one shared index (the JAX engine writes ``index_cache``, the port's
  engine loads it) both engines tune the same ``nprobe`` on the same
  proxy and answer alike at it. That check runs on the cosine metric,
  whose probe is float32 in both packages (the euclidean probe is
  ``precision='default'``: bf16 operands in the port, float32 in JAX on
  the CPU).
"""

import base64
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.retrieval.server import RetrievalEngine as JaxEngine
from art_sbir_tpu_torch.cli import serve as port_serve
from art_sbir_tpu_torch.ops import ivf as ivf_ops
from art_sbir_tpu_torch.ops import pq as pq_ops
from art_sbir_tpu_torch.parallel import mesh as port_mesh
from art_sbir_tpu_torch.retrieval.server import MicroBatcher
from art_sbir_tpu_torch.retrieval.server import RetrievalEngine as PortEngine
from tests.test_torch_serve import (S, _assert_same_distances, _call,
                                    _jax_forward, _png, _port_forward,
                                    _served_run, data)  # noqa: F401
from tests.torch_threads import two_torch_threads  # noqa: F401


CPU = torch.device("cpu")


def _mesh(n=8):
    return port_mesh.MeshSpec(n).build([CPU] * n)


def _engine(data, **kw):
    _, _, feats, paths = data
    kw = {"image_size": S, "k_max": 5, "max_batch": 8, **kw}
    return PortEngine(_port_forward, feats, list(paths), device="cpu", **kw)


def _jax_engine(data, **kw):
    _, _, feats, paths = data
    kw = {"image_size": S, "k_max": 5, "max_batch": 8, **kw}
    return JaxEngine(_jax_forward, feats, list(paths), **kw)


def _same_as(ref, eng, batch, k=None):
    """``eng`` answers ``batch`` as ``ref`` (paths, then distances)."""
    v0, i0 = ref.search_arrays(batch)
    v1, i1 = eng.search_arrays(batch)
    k = k or v1.shape[1]
    np.testing.assert_array_equal(i1, i0[:, :k])
    _assert_same_distances(v1, v0[:, :k], eng.metric, 2 * batch[0].size)


# ------------------------------------------------------------ single card

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_ivf_route_full_probe_matches_exact_engines(data, metric):
    _, queries, _, _ = data
    exact = _jax_engine(data, metric=metric)
    eng = _engine(data, metric=metric, ivf_nlist=4, ivf_nprobe=4)
    assert eng.route == "ivf" and eng._ivf.nlist == 4
    assert set(eng.startup_s) == {"ivf_build", "ivf_cached"}
    _same_as(exact, eng, queries[[2, 13, 7]])
    one = _engine(data, metric=metric, ivf_nlist=4, ivf_nprobe=1)
    out = one.search(_png(data[0][9]))
    assert out["paths"][0] == "gallery/img_9.png"
    assert 1 <= len(out["paths"]) <= 5  # +inf pads are filtered


def test_ivf_shared_index_tunes_and_answers_as_jax(data, tmp_path):
    """The JAX engine writes ``ivf.npz``; the port's engine loads it,
    tunes the same nprobe on the same proxy and answers as JAX at it."""
    _, queries, _, _ = data
    kw = dict(metric="cosine", ivf_nlist=6, ivf_nprobe=0,
              index_cache=tmp_path / "idx")
    jeng = _jax_engine(data, **kw)
    eng = _engine(data, **kw)
    assert eng.startup_s["ivf_cached"] and "ivf_tune" in eng.startup_s
    assert eng._ivf_nprobe == jeng._ivf_nprobe
    assert eng.health_stats()["ivf"] == {**jeng._ivf.stats(),
                                         "nprobe": jeng._ivf_nprobe}
    for nprobe in (1, 2, eng._ivf_nprobe):
        eng._ivf_nprobe = jeng._ivf_nprobe = nprobe
        _same_as(jeng, eng, queries[[0, 5, 11, 31]])


def test_ivf_auto_nlist_and_nprobe(data):
    imgs = data[0]
    auto = _engine(data, ivf_nlist=0, ivf_nprobe=8)
    assert auto._ivf.nlist == _jax_engine(data, ivf_nlist=0,
                                          ivf_nprobe=8)._ivf.nlist == 12
    assert auto.search(_png(imgs[4]))["paths"][0] == "gallery/img_4.png"
    tuned = _engine(data, ivf_nlist=4, ivf_nprobe=0)
    assert 1 <= tuned._ivf_nprobe <= 4
    assert tuned.search(_png(imgs[11]))["paths"][0] == "gallery/img_11.png"
    online = _engine(data, ivf_nlist=4, ivf_nprobe=0, capacity=48)
    assert isinstance(online._ivf, ivf_ops.OnlineIVF)
    assert 1 <= online._ivf_nprobe <= 4
    assert online.search(_png(imgs[6]))["paths"][0] == "gallery/img_6.png"


def _capacity_pair(data, n0, capacity, **kw):
    """(exact capacity engine, IVF capacity engine) over the first ``n0``
    rows."""
    _, _, feats, paths = data
    common = dict(image_size=S, k_max=5, max_batch=8, capacity=capacity,
                  device="cpu")
    return (PortEngine(_port_forward, feats[:n0], paths[:n0], **common),
            PortEngine(_port_forward, feats[:n0], paths[:n0], **common,
                       **kw))


def _churn(data, ref, eng, jax_ref=None):
    """Adds, removals and a freed slot reused on both engines; after each
    step every checked query gets the same paths."""
    imgs = data[0]

    def check(idx):
        for i in idx:
            a = ref.search(_png(imgs[i]))
            b = eng.search(_png(imgs[i]))
            assert a["paths"] == b["paths"]
            np.testing.assert_allclose(a["distances"], b["distances"],
                                       rtol=1e-4, atol=2e-2)
            if jax_ref is not None:
                assert jax_ref.search(_png(imgs[i]))["paths"] == b["paths"]

    engines = (ref, eng) + ((jax_ref,) if jax_ref is not None else ())
    check((0, 5))
    for e in engines:
        assert e.add_images([(_png(imgs[i]), f"added/{i}.png")
                             for i in (8, 9, 10, 11, 12, 13, 14)]) == list(
            range(6, 13))
    check((1, 8, 12))
    for e in engines:
        e.remove(["gallery/img_2.png", "added/9.png", "added/12.png"])
    check((2, 9, 4))
    for e in engines:
        e.add_images([(_png(imgs[12]), "re/12.png")])
    check((12, 0, 9))
    assert eng._ivf.stats()["live_rows"] == 6 + 7 - 3 + 1 == eng.n_valid


def test_online_ivf_engine_churn_matches_exact_engines(data):
    ref, eng = _capacity_pair(data, 6, 16, ivf_nlist=3, ivf_nprobe=3)
    assert isinstance(eng._ivf, ivf_ops.OnlineIVF) and eng.route == "ivf"
    _, _, feats, paths = data
    jax_ref = JaxEngine(_jax_forward, feats[:6], paths[:6], image_size=S,
                        k_max=5, max_batch=8, capacity=16, ivf_nlist=3,
                        ivf_nprobe=3)
    _churn(data, ref, eng, jax_ref)
    assert eng._ivf.stats()["spill_used"] == 2  # overflow is scanned too


def test_ivf_pq_routes_match_exact_engine(data, tmp_path):
    """pq_m with each pq_rerank: a covering rerank at full probe equals
    the exact engine (float32 rows; bf16 rows within bf16's rounding);
    'none' drops the rows, still self-retrieves, and save() refuses; OPQ
    threads its rotation through."""
    imgs, queries, _, _ = data
    exact = _jax_engine(data)
    kw = dict(ivf_nlist=4, ivf_nprobe=4, pq_m=4, pq_rerank_factor=1000)
    pq = _engine(data, pq_rerank="float32", **kw)
    assert pq.route == "ivf_pq" and pq.gallery.dtype == torch.float32
    _same_as(exact, pq, queries[[2, 13, 7]])
    assert {"ivf_build", "pq_build", "pq_cached"} <= set(pq.startup_s)
    bf = _engine(data, **kw)  # the default: bf16 rows
    assert bf.gallery.dtype == torch.bfloat16
    v0, i0 = exact.search_arrays(queries[[2, 13]])
    v1, i1 = bf.search_arrays(queries[[2, 13]])
    np.testing.assert_array_equal(i1[:, 0], i0[:, 0])
    np.testing.assert_allclose(v1, v0, rtol=2e-2, atol=2e-2)
    assert bf.health_stats()["pq"] == {
        "m": 4, "k_codes": 40, "bytes_per_row": 4,
        "rows_resident": "bfloat16", "rerank_factor": 1000}
    pure = _engine(data, ivf_nlist=4, ivf_nprobe=4, pq_m=4, pq_rerank="none")
    assert pure.gallery is None
    assert pure.health_stats()["pq"]["rows_resident"] == "dropped"
    assert pure.search(_png(imgs[9]))["paths"][0] == "gallery/img_9.png"
    with pytest.raises(ValueError, match="dropped"):
        pure.save(root=tmp_path)
    opq = _engine(data, pq_rerank="float32", pq_opq_iters=2, **kw)
    assert opq._pq[0].rotation is not None
    _same_as(exact, opq, queries[[2, 13, 7]])


def test_index_cache_reuse_mismatch_and_jax_loads_the_ports(data, tmp_path,
                                                           monkeypatch):
    """A second engine with the same parameters loads the port's cache
    (the build functions never run), answers alike, and so does the JAX engine
    over the port's files; a mismatch (another m, another metric) is
    rebuilt."""
    import art_sbir_tpu.ops.ivf as jax_ivf
    import art_sbir_tpu.ops.pq as jax_pq

    _, queries, _, _ = data
    kw = dict(ivf_nlist=4, ivf_nprobe=2, pq_m=4, pq_rerank="float32",
              index_cache=tmp_path / "idx")
    first = _engine(data, **kw)
    assert (tmp_path / "idx" / "ivf.npz").exists()
    assert (tmp_path / "idx" / "pq.npz").exists()
    assert not first.startup_s["ivf_cached"]
    v0, i0 = first.search_arrays(queries[[3, 11]])

    def boom(*a, **k):
        raise AssertionError("build ran despite a valid cache")

    for mod, name in ((ivf_ops, "build_ivf"), (pq_ops, "build_ivf_pq"),
                      (jax_ivf, "build_ivf"), (jax_pq, "build_ivf_pq")):
        monkeypatch.setattr(mod, name, boom)
    second = _engine(data, **kw)
    assert second.startup_s["ivf_cached"] and second.startup_s["pq_cached"]
    v1, i1 = second.search_arrays(queries[[3, 11]])
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(v1, v0)
    jeng = _jax_engine(data, **kw)  # the JAX engine over the port's files
    vj, ij = jeng.search_arrays(queries[[3, 11]])
    np.testing.assert_array_equal(ij[:, 0], i0[:, 0])
    monkeypatch.undo()
    third = _engine(data, **{**kw, "pq_m": 2})
    assert third.startup_s["ivf_cached"] and not third.startup_s["pq_cached"]
    fourth = _engine(data, **{**kw, "metric": "cosine"})
    assert not fourth.startup_s["ivf_cached"]
    assert fourth.search(_png(data[0][6]))["paths"][0] == "gallery/img_6.png"


def test_engine_guards_match_jax(data, tmp_path):
    _, _, feats, paths = data
    cases = [
        (dict(capacity=32, ivf_nlist=4), "non-empty", 0),
        (dict(quantize=True, ivf_nlist=4), "compose", None),
        (dict(pq_m=4), "requires ivf_nlist", None),
        (dict(ivf_nlist=4, pq_m=4, capacity=64), "immutable", None),
        (dict(ivf_nlist=4, pq_m=4, pq_rerank="int8"), "pq_rerank", None),
        (dict(index_cache=tmp_path / "x"), "index_cache", None),
        (dict(ivf_nlist=4, capacity=64, index_cache=tmp_path / "x"),
         "index_cache", None),
    ]
    for kw, match, rows in cases:
        f, p = (feats, paths) if rows is None else (feats[:rows], [])
        with pytest.raises(ValueError, match=match):
            JaxEngine(_jax_forward, f, p, image_size=S, **kw)
        with pytest.raises(ValueError, match=match):
            PortEngine(_port_forward, f, p, image_size=S, device="cpu", **kw)


# ----------------------------------------------------------------- sharded

def test_sharded_ivf_engine_full_probe_auto_nprobe_and_healthz(data):
    """mesh + ivf_nlist: one local index a shard (5 rows each on 8 CPU
    shards); full probe equals the exact engine; /healthz over HTTP
    carries the sharded stats; auto nprobe composes; k_max past a shard
    raises."""
    imgs, queries, _, _ = data
    exact = _jax_engine(data, k_max=2)
    sharded = _engine(data, k_max=2, mesh=_mesh(), ivf_nlist=2, ivf_nprobe=2)
    assert isinstance(sharded._ivf, ivf_ops.ShardedIVF)
    assert sharded._ivf.n_shards == 8 and sharded.route == "ivf"
    _same_as(exact, sharded, queries[[3, 11, 7]])
    batcher = MicroBatcher(sharded, window_ms=0.0)
    httpd = port_serve.Server(("127.0.0.1", 0),
                              port_serve.make_handler(sharded, batcher))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        code, health = _call(httpd.server_address[1], "/healthz")
        assert code == 200 and health["shards"] == 8
        assert (health["ivf"]["n_shards"], health["ivf"]["rows_per_shard"],
                health["ivf"]["nprobe"]) == (8, 5, 2)
    finally:
        httpd.shutdown()
        batcher.close()
    auto = _engine(data, k_max=2, mesh=_mesh(), ivf_nlist=2, ivf_nprobe=0)
    assert 1 <= auto._ivf_nprobe <= 2
    assert auto.search(_png(imgs[5]))["paths"][0] == "gallery/img_5.png"
    with pytest.raises(ValueError, match="exceeds the per-shard"):
        _engine(data, k_max=6, mesh=_mesh(), ivf_nlist=2)


def test_sharded_online_ivf_engine_churn(data):
    """mesh + capacity + ivf_nlist: shared centroids, per-shard tables
    (10 slots a shard); adds land in shards that started empty."""
    ref, eng = _capacity_pair(data, 6, 80, mesh=_mesh(), ivf_nlist=3,
                              ivf_nprobe=3)
    assert isinstance(eng._ivf, ivf_ops.ShardedOnlineIVF)
    assert eng._ivf.n_shards == 8 and eng._ivf.cap_local == 10
    _churn(data, ref, eng)
    st = eng.health_stats()["ivf"]
    assert st["n_shards"] == 8 and st["rows_per_shard"] == 10
    _, auto = _capacity_pair(data, 6, 80, mesh=_mesh(), ivf_nlist=3,
                             ivf_nprobe=0)
    assert 1 <= auto._ivf_nprobe <= 3
    assert auto.search(_png(data[0][4]))["paths"][0] == "gallery/img_4.png"


def test_sharded_cache_and_pq_route(data, tmp_path, monkeypatch):
    """The sharded IVF and PQ persist (``ivf_sharded.npz``,
    ``pq_sharded.npz``; a second engine skips both builds); full probe
    and a covering rerank equal the exact engine; another mesh size
    rebuilds; the rows-dropped mode self-retrieves."""
    imgs, queries, _, _ = data
    exact = _jax_engine(data, k_max=2)
    kw = dict(k_max=2, ivf_nlist=2, ivf_nprobe=2, pq_m=4,
              pq_rerank_factor=1000, pq_rerank="float32",
              index_cache=tmp_path / "spq")
    spq = _engine(data, mesh=_mesh(), **kw)
    assert spq.route == "ivf_pq"
    assert (tmp_path / "spq" / "ivf_sharded.npz").exists()
    assert (tmp_path / "spq" / "pq_sharded.npz").exists()
    _same_as(exact, spq, queries[[2, 13, 7]])

    def boom(*a, **k):
        raise AssertionError("build ran despite a valid cache")

    monkeypatch.setattr(ivf_ops, "build_ivf", boom)
    monkeypatch.setattr(pq_ops, "build_ivf_pq_sharded", boom)
    second = _engine(data, mesh=_mesh(), **kw)
    v1, i1 = spq.search_arrays(queries[[2, 13, 7]])
    v2, i2 = second.search_arrays(queries[[2, 13, 7]])
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_array_equal(v2, v1)
    monkeypatch.undo()
    other = _engine(data, mesh=_mesh(4), **kw)
    assert not other.startup_s["ivf_cached"]
    assert other.search(_png(imgs[6]))["paths"][0] == "gallery/img_6.png"
    pure = _engine(data, mesh=_mesh(), k_max=2, ivf_nlist=2, ivf_nprobe=2,
                   pq_m=4, pq_rerank="none")
    assert pure.gallery is None
    assert pure.search(_png(imgs[9]))["paths"][0] == "gallery/img_9.png"


# --------------------------------------------------------------------- CLI

def test_serve_cli_ivf_flags_match_jax_defaults():
    args = port_serve.parse_args(["-f", "Run", "--features", "c"])
    assert (args.ivf_nlist, args.ivf_nprobe, args.pq_m, args.pq_rerank,
            args.pq_rerank_factor, args.pq_opq_iters, args.index_cache) == (
        None, 0, None, "bfloat16", 64, 0, None)  # JAX cli/serve.py:345-393
    args = port_serve.parse_args([
        "-f", "Run", "--features", "c", "--ivf_nlist", "0", "--ivf_nprobe",
        "4", "--pq_m", "64", "--pq_rerank", "none", "--pq_rerank_factor",
        "16", "--pq_opq_iters", "2", "--index_cache", "d"])
    assert (args.ivf_nlist, args.ivf_nprobe, args.pq_m, args.pq_rerank,
            args.pq_rerank_factor, args.pq_opq_iters, args.index_cache) == (
        0, 4, 64, "none", 16, 2, "d")
    with pytest.raises(SystemExit):
        port_serve.parse_args(["-f", "Run", "--pq_rerank", "int8"])


def test_serve_cli_ivf_pq_over_http(tmp_path, monkeypatch):
    """``--ivf_nlist 0 --ivf_nprobe 0 --pq_m 64 --pq_rerank none
    --index_cache`` with ``--device cpu``: /healthz carries the index
    stats, /search answers, /save refuses; a restart loads the cache."""
    monkeypatch.chdir(tmp_path)
    kw = dict(capacity=None, ivf_nlist=0, ivf_nprobe=0, pq_m=64,
              pq_rerank="none", pq_rerank_factor=64, pq_opq_iters=0,
              index_cache=str(tmp_path / "idx"))
    args = _served_run(tmp_path, n=12, **kw)
    engine, batcher = port_serve.build_engine(args)
    port_serve.warmup(engine, batcher)
    assert engine.route == "ivf_pq" and not engine.startup_s["ivf_cached"]
    httpd = port_serve.Server(("127.0.0.1", 0),
                              port_serve.make_handler(engine, batcher))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    img = np.zeros((32, 32, 3), np.uint8)
    try:
        code, health = _call(port, "/healthz")
        assert code == 200 and health["ivf"]["nlist"] == 6
        assert health["pq"]["rows_resident"] == "dropped"
        assert 1 <= health["ivf"]["nprobe"] <= 6
        code, out = _call(port, "/search", {
            "image_b64": base64.b64encode(_png(img)).decode(), "k": 2})
        assert code == 200 and len(out["paths"]) == 2
        code, out = _call(port, "/save", {})
        assert code == 400 and "dropped" in out["error"]
    finally:
        httpd.shutdown()
        batcher.close()
    again, batcher = port_serve.build_engine(args)
    batcher.close()
    assert again.startup_s["ivf_cached"] and again.startup_s["pq_cached"]
    assert again._ivf_nprobe == engine._ivf_nprobe


def test_serve_cli_online_and_sharded_ivf(tmp_path):
    """``--capacity 16 --ivf_nlist 0`` adds and removes through the
    online IVF; ``--n_devices 2 --ivf_nlist 0`` shards it."""
    args = _served_run(tmp_path, n=8, ivf_nlist=0, ivf_nprobe=0)
    engine, batcher = port_serve.build_engine(args)
    try:
        rng = np.random.default_rng(3)
        new = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
        assert engine.add_images([(_png(new), "new.png")]) == [8]
        assert engine.search(_png(new))["paths"][0] == "new.png"
        assert engine._ivf.stats()["live_rows"] == 9
        assert engine.remove(["new.png"]) == [8]
        assert "new.png" not in engine.search(_png(new))["paths"]
    finally:
        batcher.close()
    run = _served_run(tmp_path / "sh", n=12, capacity=None, n_devices=2,
                      ivf_nlist=0, ivf_nprobe=0)
    engine, batcher = port_serve.build_engine(run)
    batcher.close()
    assert isinstance(engine._ivf, ivf_ops.ShardedIVF)
    assert engine.health_stats()["ivf"]["n_shards"] == 2


def test_jax_serve_cache_loads_in_the_port(tmp_path):
    """Index files written by the JAX engine serve in the port's and the
    other way round (cosine: the same probe in both packages)."""
    feats = np.random.default_rng(5).standard_normal((64, 32)).astype(
        np.float32)
    paths = [f"g/{i}.png" for i in range(64)]
    kw = dict(metric="cosine", image_size=S, k_max=4, ivf_nlist=0,
              ivf_nprobe=0, pq_m=8, pq_rerank="none")

    def jfwd(x):
        return jnp.asarray(feats)[: x.shape[0]]

    def tfwd(x):
        return torch.from_numpy(feats)[: x.shape[0]]

    for first, second, cache in (("jax", "port", "a"), ("port", "jax", "b")):
        engines = {}
        for who in (first, second):
            if who == "jax":
                engines[who] = JaxEngine(jfwd, feats, paths,
                                         index_cache=tmp_path / cache, **kw)
            else:
                engines[who] = PortEngine(tfwd, feats, paths, device="cpu",
                                          index_cache=tmp_path / cache, **kw)
        assert engines["port"]._ivf_nprobe == engines["jax"]._ivf_nprobe
        batch = np.zeros((4, S, S, 3), np.uint8)  # the forwards ignore it
        v0, i0 = engines["jax"].search_arrays(batch)
        v1, i1 = engines["port"].search_arrays(batch)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_allclose(v1, v0, rtol=1e-5, atol=1e-6)
