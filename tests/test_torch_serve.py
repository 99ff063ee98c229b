"""The port's serving slice against the JAX package, on the CPU.

* preprocessing: ``finish_gallery_batch`` within an ulp (XLA compiles the
  two divisions into reciprocal multiplies and an FMA; the port keeps the
  source's divisions), PIL decoding and the resize geometry identical;
* ``RetrievalEngine``: the exact route and the K1 route (forced by lowering
  the threshold in both packages) return the same top-k paths as the JAX
  engine on the same features and forward, and the same distances: squared
  euclidean at rtol 1e-5 with an absolute floor of 1e-5 x (|q|^2 + |g|^2),
  the size of the terms whose cancellation gives a small distance; cosine
  at rtol 1e-5. Capacity adds, removals and tombstones move the same
  slots;
* the int8 route (``quantize=True``): the plain int8 scan and the K2 route
  (forced by lowering ``QUANT_FUSED_GALLERY_THRESHOLD`` in the JAX package
  and by patching ``quant_fused.kernel_takes`` in the port, whose CPU
  engines take the plain scan) return the same paths as the JAX engine,
  distances at rtol 1e-6 (cosine
  with an absolute 1e-6: ``1 - sim`` of a near match cancels against 1);
  bf16-resident rerank rows give the same results in both packages, and a
  bf16 engine saves the same cache bytes as the JAX engine;
* the feature cache: byte-compatible in both directions;
* ``cli/serve.py`` over HTTP with ``--device cpu``, including the two
  faults of the JAX CLI that the port does not carry over.
"""

import argparse
import base64
import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import art_sbir_tpu.retrieval.rank as jax_rank
from art_sbir_tpu.data.loader import decode_image as jax_decode_image
from art_sbir_tpu.ops import resize as jax_resize
from art_sbir_tpu.retrieval import embed as jax_embed
from art_sbir_tpu.retrieval.server import RetrievalEngine as JaxEngine
from art_sbir_tpu.train.prepare import finish_gallery_batch as jax_finish
import art_sbir_tpu_torch.retrieval.rank as port_rank
from art_sbir_tpu_torch.cli import serve as port_serve
from art_sbir_tpu_torch.core.checkpoint import save_state_dict
from art_sbir_tpu_torch.data.loader import decode_bytes, decode_image
from art_sbir_tpu_torch.models.resnet import create_encoder
from art_sbir_tpu_torch.ops import quant_fused as qf
from art_sbir_tpu_torch.ops import resize as port_resize
from art_sbir_tpu_torch.ops import retrieval_fused as rf
from art_sbir_tpu_torch.retrieval import embed as port_embed
from art_sbir_tpu_torch.retrieval.server import MicroBatcher
from art_sbir_tpu_torch.retrieval.server import RetrievalEngine as PortEngine
from art_sbir_tpu_torch.train.prepare import finish_gallery_batch
from tests.torch_threads import two_torch_threads  # noqa: F401


S = 16  # image side of the engine tests


def _png(arr_u8: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, format="PNG")
    return buf.getvalue()


# one float32 multiply: XLA and torch compute it identically (XLA turns a
# division by 255 into this multiply, torch would divide)
INV255 = np.float32(1 / 255)


def _jax_forward(x_u8):
    return (x_u8.astype(jnp.float32) * INV255).reshape(x_u8.shape[0], -1)


def _port_forward(x_u8):
    return (x_u8.float() * float(INV255)).reshape(x_u8.shape[0], -1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, size=(40, S, S, 3)).astype(np.uint8)
    noise = rng.integers(-20, 21, size=imgs.shape)
    queries = np.clip(imgs.astype(np.int64) + noise, 0, 255).astype(np.uint8)
    feats = np.asarray(_jax_forward(jnp.asarray(imgs)))
    paths = [f"gallery/img_{i}.png" for i in range(40)]
    return imgs, queries, feats, paths


def _engines(data, **kw):
    _, _, feats, paths = data
    kw = dict(image_size=S, k_max=5, max_batch=8, **kw)
    return (JaxEngine(_jax_forward, feats, paths, **kw),
            PortEngine(_port_forward, feats, paths, device="cpu", **kw))


def _assert_same_distances(v1, v0, metric, scale):
    if metric == "cosine":
        np.testing.assert_allclose(v1, v0, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(v1 ** 2, v0 ** 2, rtol=1e-5,
                                   atol=1e-5 * scale)


def _assert_same_search(jax_eng, port_eng, batch):
    v0, i0 = jax_eng.search_arrays(batch)
    v1, i1 = port_eng.search_arrays(batch)
    np.testing.assert_array_equal(i1, i0)
    scale = 2 * batch[0].size  # |q|^2 + |g|^2 <= 2 x (pixels in [0, 1])
    _assert_same_distances(v1, v0, port_eng.metric, scale)
    return v1, i1


# ---------------------------------------------------------- preprocessing

def test_finish_gallery_batch_bit_identical(rng):
    x = rng.integers(0, 256, size=(3, 8, 8, 3)).astype(np.uint8)
    want = np.asarray(jax_finish(jnp.asarray(x)))
    got = finish_gallery_batch(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert port_resize.CLIP_MEAN == jax_resize.CLIP_MEAN
    assert port_resize.CLIP_STD == jax_resize.CLIP_STD


def test_resize_geometry_matches_jax():
    for h, w in ((480, 640), (640, 480), (224, 224), (300, 1001)):
        for size in (64, 224):
            hw = port_resize.shortest_side_size(h, w, size)
            assert hw == jax_resize.shortest_side_size(h, w, size)
            assert (port_resize.center_crop_slices(*hw, size)
                    == jax_resize.center_crop_slices(*hw, size))


@pytest.mark.parametrize("mode", ["square", "shortest_crop"])
@pytest.mark.parametrize("grayscale", [False, True])
def test_decode_matches_jax(rng, mode, grayscale):
    img = rng.integers(0, 256, size=(37, 53, 3)).astype(np.uint8)
    data = _png(img)
    want = jax_decode_image(io.BytesIO(data), 24, mode, grayscale)
    np.testing.assert_array_equal(
        decode_bytes(data, 24, mode, grayscale), want)
    np.testing.assert_array_equal(
        decode_image(io.BytesIO(data), 24, mode, grayscale), want)


def test_decode_rejects_unknown_mode(rng):
    with pytest.raises(ValueError, match="resize_mode"):
        decode_bytes(_png(np.zeros((4, 4, 3), np.uint8)), 4, "stretch")


def test_embed_batched_matches_jax(data):
    imgs = data[0][:37]  # a padded tail
    want = jax_embed.embed_batched(_jax_forward, imgs, batch_size=32)
    got = port_embed.embed_batched(_port_forward, imgs, batch_size=32,
                                   device="cpu")
    np.testing.assert_array_equal(got, want)
    loader = lambda s, c: imgs[s:s + c]  # noqa: E731
    dev = port_embed.embed_batched(_port_forward, loader, n_images=37,
                                   device="cpu", return_device=True)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), want)


# ------------------------------------------------------------ the engine

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_exact_route_matches_jax_engine(data, metric):
    _, queries, _, _ = data
    jax_eng, port_eng = _engines(data, metric=metric)
    assert not jax_eng.use_fused and port_eng.route == "exact"
    _assert_same_search(jax_eng, port_eng, queries[[2, 9, 4]])  # bucket 4
    _assert_same_search(jax_eng, port_eng, queries[:8])


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_k1_route_matches_jax_engine(data, monkeypatch, metric):
    _, queries, _, _ = data
    monkeypatch.setattr(jax_rank, "FUSED_GALLERY_THRESHOLD", 1)
    monkeypatch.setattr(port_rank, "FUSED_GALLERY_THRESHOLD", 1)
    jax_eng, port_eng = _engines(data, metric=metric)
    assert jax_eng.use_fused and port_eng.route == "K1"
    before = rf.counters.fallback_rows
    v, i = _assert_same_search(jax_eng, port_eng, queries[[3, 11, 30]])
    assert list(i[:, 0]) == [3, 11, 30]
    assert rf.counters.fallback_rows == before
    # the K1 route agrees with the port's own exact route
    monkeypatch.setattr(port_rank, "FUSED_GALLERY_THRESHOLD", 10 ** 9)
    plain = _engines(data, metric=metric)[1]
    assert plain.route == "exact"
    v2, i2 = plain.search_arrays(queries[[3, 11, 30]])
    np.testing.assert_array_equal(i2, i)
    _assert_same_distances(v2, v, metric, 2 * S * S * 3)


def _assert_same_quant_search(jax_eng, port_eng, batch):
    v0, i0 = jax_eng.search_arrays(batch)
    v1, i1 = port_eng.search_arrays(batch)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(
        v1, v0, rtol=1e-6, atol=1e-6 if port_eng.metric == "cosine" else 0.0)
    return v1, i1


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_quantized_route_matches_jax_engine(data, metric):
    _, queries, _, _ = data
    jax_eng, port_eng = _engines(data, metric=metric, quantize=True)
    assert jax_eng._qg is not None and not jax_eng._quant_fused
    assert port_eng._qg is not None and port_eng._rerank_factor == 4
    assert port_eng.route == "int8"
    _, i = _assert_same_quant_search(jax_eng, port_eng, queries[[2, 9, 4]])
    assert list(i[:, 0]) == [2, 9, 4]
    _assert_same_quant_search(jax_eng, port_eng, queries[:8])


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_k2_route_matches_jax_engine(data, monkeypatch, metric):
    _, queries, _, _ = data
    monkeypatch.setattr(jax_rank, "QUANT_FUSED_GALLERY_THRESHOLD", 1)
    monkeypatch.setattr(qf, "kernel_takes", lambda *a: True)
    jax_eng, port_eng = _engines(data, metric=metric, quantize=True)
    assert jax_eng._quant_fused and port_eng.route == "K2"
    before = qf.counters.fallback_rows
    v, i = _assert_same_quant_search(jax_eng, port_eng, queries[[3, 11, 30]])
    assert list(i[:, 0]) == [3, 11, 30]
    assert qf.counters.fallback_rows == before
    # the K2 route agrees with the port's own plain int8 route
    monkeypatch.setattr(qf, "kernel_takes", lambda *a: False)
    plain = _engines(data, metric=metric, quantize=True)[1]
    assert plain.route == "int8"
    v2, i2 = plain.search_arrays(queries[[3, 11, 30]])
    np.testing.assert_array_equal(i2, i)
    np.testing.assert_array_equal(v2, v)


def test_k2_route_needs_a_small_candidate_budget(data, monkeypatch):
    """K2 takes a gallery on the card with rerank_factor * k_max <= 1,024
    candidates and 16-byte rows, whatever its size; the engine asks it
    with its own device, budget and width."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert qf.kernel_takes(cuda, 8 * 128, 1024)
    assert not qf.kernel_takes(cuda, 8 * 128 + 1, 1024)
    assert not qf.kernel_takes(cuda, 40, 1000)
    assert not qf.kernel_takes(cpu, 40, 1024)
    seen = []
    monkeypatch.setattr(qf, "kernel_takes",
                        lambda *a: seen.append(a) or False)
    _, _, feats, paths = data
    PortEngine(_port_forward, feats, paths, k_max=33, rerank_factor=4,
               image_size=S, quantize=True, device="cpu")
    assert seen == [(torch.device("cpu"), 132, feats.shape[1])]


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_bf16_rerank_rows_match_jax_engine(data, metric):
    _, queries, _, _ = data
    jax_eng, port_eng = _engines(data, metric=metric, quantize=True,
                                 rerank_dtype="bfloat16")
    assert port_eng.gallery.dtype == torch.bfloat16
    assert jax_eng.gallery.dtype == jnp.bfloat16
    _assert_same_quant_search(jax_eng, port_eng, queries[[3, 8]])


def test_bf16_engine_saves_the_jax_engines_cache(tmp_path, data):
    _, _, feats, paths = data
    jax_eng, port_eng = _engines(data, quantize=True,
                                 rerank_dtype="bfloat16")
    f0 = jax_eng.save(root=tmp_path / "jax")
    f1 = port_eng.save(root=tmp_path / "port")
    got_paths, got = port_embed.load_image_features(f1, tmp_path / "port")
    assert [str(p) for p in got_paths] == paths and got.dtype == np.float32
    want = torch.from_numpy(feats).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
    for name in ("image_paths.csv", "image_features.npy"):
        assert ((tmp_path / "jax" / f0 / name).read_bytes()
                == (tmp_path / "port" / f1 / name).read_bytes())


def test_quantize_validation_matches_jax(data):
    _, _, feats, paths = data
    for cls, fwd, extra in ((JaxEngine, _jax_forward, {}),
                            (PortEngine, _port_forward, {"device": "cpu"})):
        kw = dict(image_size=S, **extra)
        with pytest.raises(ValueError, match="immutable"):
            cls(fwd, feats, paths, capacity=64, quantize=True, **kw)
        with pytest.raises(ValueError, match="rerank_dtype"):
            cls(fwd, feats, paths, quantize=True, rerank_dtype="int8", **kw)
        with pytest.raises(ValueError, match="quantize=True"):
            cls(fwd, feats, paths, rerank_dtype="bfloat16", **kw)


def test_capacity_add_remove_match_jax_engine(data):
    imgs, queries, feats, _ = data
    kw = dict(image_size=S, k_max=10, max_batch=8, capacity=8)
    paths = ["gallery/img_0.png", "gallery/img_1.png"]
    jax_eng = JaxEngine(_jax_forward, feats[:2], paths, **kw)
    port_eng = PortEngine(_port_forward, feats[:2], paths, device="cpu",
                          **kw)
    for eng in (jax_eng, port_eng):  # empty slots never appear
        out = eng.search(_png(queries[1]))
        assert out["paths"][0] == "gallery/img_1.png"
        assert len(out["paths"]) == 2
    items = [(_png(imgs[i]), f"added/img_{i}.png") for i in (5, 6, 7)]
    assert jax_eng.add_images(items) == port_eng.add_images(items) == [2, 3, 4]
    _assert_same_search(jax_eng, port_eng, queries[[6, 1]])
    assert jax_eng.remove(["added/img_6.png"]) == [3]
    assert port_eng.remove(["added/img_6.png"]) == [3]
    _assert_same_search(jax_eng, port_eng, queries[[6, 1]])
    out = port_eng.search(_png(queries[6]))
    assert "added/img_6.png" not in out["paths"] and len(out["paths"]) == 4
    item = [(_png(imgs[9]), "added/img_9.png")]
    assert jax_eng.add_images(item) == port_eng.add_images(item) == [3]
    _assert_same_search(jax_eng, port_eng, queries[[9, 5, 1]])
    assert port_eng.image_paths == jax_eng.image_paths
    assert port_eng.n_valid == jax_eng.n_valid == 5
    with pytest.raises(KeyError):
        port_eng.remove(["nope.png"])
    with pytest.raises(ValueError, match="full"):
        port_eng.add_images([(_png(imgs[i]), f"x{i}") for i in range(4)])


def test_immutable_engine_refuses_updates(data):
    _, port_eng = _engines(data)
    with pytest.raises(ValueError, match="immutable"):
        port_eng.add_images([(_png(data[0][0]), "a.png")])
    with pytest.raises(ValueError, match="immutable"):
        port_eng.remove(["gallery/img_0.png"])
    with pytest.raises(ValueError, match="empty"):
        PortEngine(_port_forward, np.zeros((0, 4), np.float32), [],
                   device="cpu")
    with pytest.raises(ValueError, match="paths"):
        PortEngine(_port_forward, np.zeros((4, 2), np.float32), ["a"],
                   device="cpu")


def test_microbatcher_coalesces(data):
    imgs = data[0]
    _, port_eng = _engines(data)
    batcher = MicroBatcher(port_eng, window_ms=30.0)
    results = {}
    try:
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, batcher.search(_png(imgs[i]), k=1))) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i in range(8):
            assert results[i]["paths"] == [f"gallery/img_{i}.png"]
        s = batcher.stats.snapshot()
        assert s["requests"] == 8 and s["batches"] < 8, s
        with pytest.raises(Exception):
            batcher.search(b"not an image")
    finally:
        batcher.close()


def test_batcher_call_runs_on_the_dispatch_thread(data):
    _, port_eng = _engines(data)
    batcher = MicroBatcher(port_eng, window_ms=0.0)
    try:
        name = batcher.call(lambda: threading.current_thread().name)
        assert name == "retrieval-microbatch"
        with pytest.raises(ZeroDivisionError):
            batcher.call(lambda: 1 / 0)
        out = batcher.search(_png(data[0][4]), k=1)  # still serving
        assert out["paths"] == ["gallery/img_4.png"]
        assert batcher.stats.snapshot()["requests"] == 1
    finally:
        batcher.close()


# ------------------------------------------------------------- the cache

@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_feature_cache_byte_compatible(tmp_path, data, direction):
    _, _, feats, paths = data
    writers = {"port": port_embed.save_image_features,
               "jax": jax_embed.save_image_features}
    readers = {"port": port_embed.load_image_features,
               "jax": jax_embed.load_image_features}
    src, dst = direction.split("_to_")
    folder = writers[src]("Model", "Set", paths, feats, root=tmp_path / src,
                          timestamp="2026-01-01_00-00")
    got_paths, got = readers[dst](folder, tmp_path / src)
    assert [str(p) for p in got_paths] == paths
    np.testing.assert_array_equal(got, feats)
    if dst == "port":  # the engine's reader: the same, paths as strings
        str_paths, str_got = port_embed.load_feature_cache(folder,
                                                           tmp_path / src)
        assert str_paths == paths
        np.testing.assert_array_equal(str_got, feats)
    other = writers[dst]("Model", "Set", paths, feats, root=tmp_path / dst,
                         timestamp="2026-01-01_00-00")
    assert other == folder
    for name in ("image_paths.csv", "image_features.npy"):
        assert ((tmp_path / src / folder / name).read_bytes()
                == (tmp_path / dst / folder / name).read_bytes())


def test_legacy_csv_cache(tmp_path, data):
    feats, paths = data[2][:3].astype(np.float64), data[3][:3]
    folder = tmp_path / "Legacy_Set_ts"
    folder.mkdir()
    (folder / "image_paths.csv").write_text("\n".join(paths) + "\n")
    np.savetxt(folder / "image_features.csv", feats, delimiter=",")
    p1, f1 = port_embed.load_image_features("Legacy_Set_ts", tmp_path)
    p0, f0 = jax_embed.load_image_features("Legacy_Set_ts", tmp_path)
    assert p1 == p0
    np.testing.assert_array_equal(f1, f0)


# ------------------------------------------------------ the CLI over HTTP

def _served_run(tmp_path, n=6, **over):
    """A run folder (tiny tower geometry) and a 1024-d feature cache."""
    run = "ModifiedResNet_Tiny_2026"
    rdir = tmp_path / "results" / run
    rdir.mkdir(parents=True)
    (rdir / "training_params.json").write_text(json.dumps(
        {"width": 8, "layers": [1, 1, 1, 1], "image_size": 32}))
    feats = np.random.default_rng(1).standard_normal((n, 1024)).astype(
        np.float32)
    folder = port_embed.save_image_features(
        "Tiny", "Set", [f"g/{i}.png" for i in range(n)], feats,
        root=tmp_path / "features", timestamp="ts")
    args = dict(folder=run, features=folder,
                results_root=str(tmp_path / "results"),
                models_root=str(tmp_path / "models"),
                feature_root=str(tmp_path / "features"), metric=None,
                k_max=3, max_batch=4, window_ms=1.0, capacity=16,
                device="cpu", bn_stats="auto")
    args.update(over)
    return argparse.Namespace(**args)


def _call(port, path, obj=None):
    url = f"http://127.0.0.1:{port}{path}"
    req = (urllib.request.Request(url, data=json.dumps(obj).encode())
           if obj is not None else url)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)  # /save writes under data/image_features
    args = _served_run(tmp_path)
    engine, batcher = port_serve.build_engine(args)
    assert "serving fresh init" in capsys.readouterr().out
    port_serve.warmup(engine, batcher)  # on the batcher's thread
    assert engine.n_valid == 6 and engine.device.type == "cpu"
    httpd = port_serve.Server(("127.0.0.1", 0),
                              port_serve.make_handler(engine, batcher))
    assert httpd.request_queue_size > 8  # a burst of clients fits
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    rng = np.random.default_rng(2)
    new = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    other = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    b64 = lambda a: base64.b64encode(_png(a)).decode()  # noqa: E731
    try:
        code, health = _call(port, "/healthz")
        assert code == 200 and health["gallery_size"] == 6
        assert health["capacity"] == 16 and health["k_max"] == 3
        code, out = _call(port, "/add", {"image_b64": b64(new),
                                         "path": "new.png"})
        assert code == 200 and out == {"indices": [6], "gallery_size": 7}
        code, out = _call(port, "/search", {"image_b64": b64(new), "k": 2})
        assert code == 200 and out["paths"][0] == "new.png"
        assert len(out["paths"]) == 2
        code, out = _call(port, "/search_batch",
                          {"images_b64": [b64(new), b64(other)], "k": 1})
        assert code == 200 and out["results"][0]["paths"] == ["new.png"]
        assert len(out["results"]) == 2
        code, out = _call(port, "/remove", {"paths": ["new.png"]})
        assert code == 200 and out == {"removed": [6], "gallery_size": 6}
        code, out = _call(port, "/search", {"image_b64": b64(new)})
        assert code == 200 and "new.png" not in out["paths"]
        code, out = _call(port, "/save", {"dataset_name": "online"})
        assert code == 200
        paths, feats = port_embed.load_image_features(out["folder"])
        assert len(paths) == 6 and feats.shape == (6, 1024)
        code, stats = _call(port, "/stats")
        assert code == 200 and stats["requests"] >= 2
        assert _call(port, "/search", {"image_b64": "!!"})[0] == 400
        assert _call(port, "/nope")[0] == 404
    finally:
        httpd.shutdown()
        batcher.close()


def test_quantize_flags(tmp_path):
    """``--quantize``, ``--rerank_factor`` and ``--rerank_dtype``: the JAX
    CLI's defaults and choices, passed on by ``build_engine``."""
    args = port_serve.parse_args(["-f", "Run", "--features", "c"])
    assert (args.quantize, args.rerank_factor, args.rerank_dtype) == (
        False, 4, "float32")
    args = port_serve.parse_args(["-f", "Run", "--features", "c",
                                  "--quantize", "--rerank_factor", "2",
                                  "--rerank_dtype", "bfloat16"])
    assert (args.quantize, args.rerank_factor, args.rerank_dtype) == (
        True, 2, "bfloat16")
    with pytest.raises(SystemExit):
        port_serve.parse_args(["-f", "Run", "--rerank_dtype", "int8"])
    engine, batcher = port_serve.build_engine(_served_run(
        tmp_path, capacity=None, quantize=True, rerank_factor=2,
        rerank_dtype="bfloat16"))
    try:
        assert engine._qg is not None and engine._rerank_factor == 2
        assert engine.gallery.dtype == torch.bfloat16
        assert engine.route == "int8"
        port_serve.warmup(engine, batcher)  # the int8 route per bucket
        img = np.zeros((2, 32, 32, 3), np.uint8)
        vals, idx = engine.search_arrays(img)
        assert idx.shape == (2, 3) and np.isfinite(vals).all()
    finally:
        batcher.close()
    engine, batcher = port_serve.build_engine(_served_run(
        tmp_path / "plain", capacity=None))
    batcher.close()
    assert engine._qg is None and engine.gallery.dtype == torch.float32


def test_folder_without_features_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="--features"):
        port_serve.build_engine(_served_run(tmp_path, features=None))


def test_warmup_covers_add_path_of_a_full_engine(tmp_path):
    """Not carried over from the JAX CLI: its warmup skips the /add path
    when a capacity engine starts full. The port's warmup embeds through
    the /add path whatever the fill, and writes nothing."""
    engine, batcher = port_serve.build_engine(
        _served_run(tmp_path, capacity=6))
    try:
        calls = []
        embed_items = engine.embed_items
        engine.embed_items = lambda items: calls.append(items) or \
            embed_items(items)
        state = (engine.n_valid, engine._next, list(engine._free),
                 list(engine.image_paths))
        port_serve.warmup(engine)
        assert len(calls) == 1
        assert (engine.n_valid, engine._next, engine._free,
                engine.image_paths) == state
    finally:
        batcher.close()


def test_bn_sketch_needs_the_main_checkpoint(tmp_path):
    """Not carried over from the JAX CLI: ``--bn_stats auto`` there loads a
    ``_bn_sketch`` sibling even when the main checkpoint is missing. The
    port loads it only beside a restored checkpoint."""
    args = _served_run(tmp_path)
    encoder = create_encoder(
        device="cpu", input_resolution=32, width=8, layers=(1, 1, 1, 1))
    stats = {k: v + 1.0 for k, v in encoder.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    save_state_dict(tmp_path / "models" / f"{args.folder}_bn_sketch.pt",
                    stats)
    engine, batcher = port_serve.build_engine(args)
    batcher.close()
    assert not engine.per_modality_bn
    save_state_dict(tmp_path / "models" / f"{args.folder}.pt",
                    encoder.state_dict())
    engine, batcher = port_serve.build_engine(args)
    batcher.close()
    assert engine.per_modality_bn
    with pytest.raises(SystemExit, match="no export"):
        port_serve.build_engine(_served_run(tmp_path / "x",
                                            bn_stats=str(tmp_path / "nope")))
