"""The port's ``retrieval/rank.py`` against the JAX package's, on the CPU.

* ``sketch_stem_to_name`` and ``positive_indices`` on the reference's stem
  rules (sketchy ``id-n``, kaggle ``id``, sketchit ``idx-id-random``,
  artworks full stems, 4+ parts a certain miss);
* ``_describe`` (numpy) against JAX's pandas ``describe()`` at rtol 1e-12;
* ``evaluate_retrieval`` on the same features, both metrics, with missing
  positives and ``query_chunk`` smaller than Q, on the exact route and on
  K1's route (forced in both packages by lowering
  ``FUSED_GALLERY_THRESHOLD``; the JAX kernel in interpret mode, the
  port's plain version of K1 on the CPU). Ranks, MRR, ``topk_acc``, the
  rank statistics and the sample paths are exact. Sample distances: two
  float32 implementations of the same expanded formulas, at rtol 1e-5
  with an absolute floor of 8 float32 ulps of the terms that cancel, on
  the squared distance ``|q|^2 + |g|^2 - 2 q.g`` (euclidean; 8 * 2^-23 *
  (|q|^2 + |g|^2)) and on ``1 - q.g / (|q||g|)`` (cosine; 8 * 2^-23): a
  near match's distance is small against the terms it is the difference
  of.
"""

import numpy as np
import pytest
import torch

import art_sbir_tpu.ops.retrieval_pallas as jax_pallas
import art_sbir_tpu.retrieval.rank as jax_rank
import art_sbir_tpu_torch.retrieval.rank as port_rank
from art_sbir_tpu_torch.ops import retrieval_fused as rf
from art_sbir_tpu_torch.parallel.mesh import MeshSpec

STEM_CASES = [
    "s/n01_2-1.png", "s/n01_2-13.png", "s/123.png", "s/3-1003-37.png",
    "s/a-b-c-d.png", "s/x.png", "s/n01_9-1.png", "s/7-n01_2-5.png"]
GALLERIES = [
    ["g/n01_2.jpg", "g/123.jpg", "g/1003.jpg", "g/x.jpg", "g/n01_2.jpg"],
    ["artworks/n01_2-1.jpg", "artworks/123.jpg", "artworks/x.jpg"],
]


@pytest.mark.parametrize("artworks", [False, True])
def test_sketch_stem_to_name_matches_jax(artworks):
    for p in STEM_CASES:
        assert (port_rank.sketch_stem_to_name(p, artworks)
                == jax_rank.sketch_stem_to_name(p, artworks)), p


@pytest.mark.parametrize("gallery", GALLERIES, ids=["photos", "artworks"])
def test_positive_indices_match_jax(gallery):
    got = port_rank.positive_indices(STEM_CASES, gallery)
    want = jax_rank.positive_indices(STEM_CASES, gallery)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() and (got >= 0).any()


@pytest.mark.parametrize("path", [
    "g/n01_2.jpg", "g/a.tar.gz", "g/.hidden", "g/foo.", "g/..", "..", ".",
    "", "g/b/", "g/b/.", "g//c.png", "/abs/d.jpeg", "e", "g/f..", "g/.g.h",
    "g/n01_2", "./x.jpg"])
def test_path_stem_is_pathlibs(path):
    """``path_stem`` (no ``Path`` a gallery row) gives ``Path.stem``."""
    from pathlib import Path
    assert port_rank.path_stem(path) == Path(path).stem
    assert port_rank.path_stem(Path(path)) == Path(path).stem


@pytest.mark.parametrize("n", [1, 2, 7, 40, 1001])
def test_describe_matches_pandas(n):
    ranks = np.random.default_rng(n).integers(1, 500, n).astype(np.int64)
    got, want = port_rank._describe(ranks), jax_rank._describe(ranks)
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want], rtol=1e-12,
                               equal_nan=True)


def _features(rng, n=300, q=40, d=32, near=0.05):
    gal = rng.standard_normal((n, d)).astype(np.float32)
    image_paths = [f"g/img{i}.jpg" for i in range(n)]
    # queries near their positives; the last 5 name no gallery image, and
    # two have 4-part stems (certain misses)
    sketch_paths = [f"s/img{i}-1.png" for i in range(q - 7)] + [
        f"s/none{i}-1.png" for i in range(5)] + ["s/a-b-c-d.png",
                                                 "s/e-f-g-h.png"]
    queries = gal[:q] + near * rng.standard_normal((q, d)).astype(np.float32)
    return queries, gal, sketch_paths, image_paths


ULPS = 8 * 2.0 ** -23


def assert_same_inference_dict(got, want, metric, queries, gallery,
                               sketch_paths, image_paths):
    """Every key of the reference dict; ranks and what comes from them
    exact, sample distances as the module docstring says (``queries``,
    ``gallery``: the features both sides ranked), ``inference_time``
    positive."""
    assert set(got) == set(want)
    for key in ("mean_reciprocal_rank", "size", "count", "mean", "std",
                "min", "25%", "50%", "75%", "max", "topk_acc"):
        assert got[key] == want[key], key
    assert got["inference_time"] > 0
    q_row = {str(p): i for i, p in enumerate(sketch_paths)}
    g_row = {str(p): i for i, p in enumerate(image_paths)}
    assert len(got["retrieval_samples"]) == len(want["retrieval_samples"])
    for gs, ws in zip(got["retrieval_samples"], want["retrieval_samples"]):
        (gk, gv), = gs.items()
        (wk, wv), = ws.items()
        assert gk == wk
        assert [p for p, _ in gv] == [p for p, _ in wv]
        a = np.array([x for _, x in gv], np.float64)
        b = np.array([x for _, x in wv], np.float64)
        if metric == "euclidean":
            q = np.asarray(queries[q_row[gk]], np.float64)
            g = np.asarray(gallery[[g_row[p] for p, _ in gv]], np.float64)
            floor = ULPS * (q @ q + np.sum(g * g, axis=1))
            np.testing.assert_array_less(np.abs(a * a - b * b),
                                         1e-5 * b * b + floor)
        else:
            np.testing.assert_array_less(np.abs(a - b),
                                         1e-5 * np.abs(b) + ULPS)


@pytest.fixture
def fused_in_both(monkeypatch):
    """K1's route in both packages at 100 gallery rows; JAX's kernel runs in
    interpret mode (the CPU backend has no Mosaic compiler)."""
    orig = jax_pallas.retrieve_fused

    def interpret(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(jax_pallas, "retrieve_fused", interpret)
    monkeypatch.setattr(jax_rank, "FUSED_GALLERY_THRESHOLD", 100)
    monkeypatch.setattr(port_rank, "FUSED_GALLERY_THRESHOLD", 100)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("route", ["exact", "fused"])
def test_evaluate_retrieval_matches_jax(rng, request, monkeypatch, metric,
                                       route):
    if route == "fused":
        request.getfixturevalue("fused_in_both")
    queries, gal, sketch_paths, image_paths = _features(rng)
    kw = dict(loss_type=metric, query_chunk=16)
    want = jax_rank.evaluate_retrieval(queries, gal, sketch_paths,
                                       image_paths, **kw)
    calls, sweep = [], rf.fused_sweep

    def counted(*a, **k):  # K1's plain version, one call a query chunk
        calls.append(a[0].shape[0])
        return sweep(*a, **k)

    monkeypatch.setattr(rf, "fused_sweep", counted)
    got = port_rank.evaluate_retrieval(queries, gal, sketch_paths,
                                       image_paths, device="cpu", **kw)
    assert calls == ([16, 16, 8] if route == "fused" else [])
    assert_same_inference_dict(got, want, metric, queries, gal, sketch_paths,
                               image_paths)
    assert got["max"] == len(image_paths) + 1  # the misses rank last
    assert 0 < got["topk_acc"][0] < 1


def test_both_routes_agree_in_the_port(rng, monkeypatch):
    queries, gal, sketch_paths, image_paths = _features(rng, near=0.3)
    exact = port_rank.evaluate_retrieval(queries, gal, sketch_paths,
                                         image_paths, device="cpu")
    monkeypatch.setattr(port_rank, "FUSED_GALLERY_THRESHOLD", 100)
    fused = port_rank.evaluate_retrieval(queries, gal, sketch_paths,
                                         image_paths, device="cpu")
    assert_same_inference_dict(fused, exact, "euclidean", queries, gal,
                               sketch_paths, image_paths)


def test_tensor_inputs_and_tiny_gallery(rng):
    """Tensors rank where they lie; k larger than the gallery is clamped
    for the search while ``topk_acc`` keeps k entries."""
    queries, gal, sketch_paths, image_paths = _features(rng, n=8, q=8)
    want = jax_rank.evaluate_retrieval(queries, gal, sketch_paths,
                                       image_paths, k=12)
    got = port_rank.evaluate_retrieval(torch.from_numpy(queries),
                                       torch.from_numpy(gal), sketch_paths,
                                       image_paths, k=12)
    assert len(got["topk_acc"]) == 12
    assert all(len(e) == 8 for s in got["retrieval_samples"]
               for e in s.values())
    assert_same_inference_dict(got, want, "euclidean", queries, gal,
                               sketch_paths, image_paths)


def test_mesh_is_still_to_port(rng):
    """A mesh on the exact route (below the K1 threshold, where the JAX
    package ranks the whole gallery too): the dict without the mesh, on
    the mesh's first device. K1 over a mesh: tests/test_torch_sharded.py."""
    queries, gal, sketch_paths, image_paths = _features(rng, n=8, q=8)
    mesh = MeshSpec(2).build([torch.device("cpu")] * 2)
    trace = {}
    got = port_rank.evaluate_retrieval(queries, gal, sketch_paths,
                                       image_paths, mesh=mesh, trace=trace)
    want = port_rank.evaluate_retrieval(queries, gal, sketch_paths,
                                        image_paths, device="cpu")
    assert trace["route"] == "exact"
    for d in (got, want):
        d.pop("inference_time")
    assert got == want


@pytest.mark.parametrize("route", ["exact", "fused"])
def test_trace_holds_what_was_scored(rng, monkeypatch, route):
    """``trace``: the route taken, the ranks the dict scores (a miss at
    N), and the top-k values and indices that the samples report."""
    if route == "fused":
        monkeypatch.setattr(port_rank, "FUSED_GALLERY_THRESHOLD", 100)
    queries, gal, sketch_paths, image_paths = _features(rng)
    trace = {}
    got = port_rank.evaluate_retrieval(queries, gal, sketch_paths,
                                       image_paths, device="cpu",
                                       query_chunk=16, trace=trace)
    assert trace["route"] == ("K1" if route == "fused" else "exact")
    ranks = trace["ranks"]
    pos = port_rank.positive_indices(sketch_paths, image_paths)
    assert (ranks[pos < 0] == len(image_paths)).all()
    assert (ranks[pos >= 0] < len(image_paths)).all()
    assert got["mean_reciprocal_rank"] == float(np.mean(1.0 / (ranks + 1)))
    assert got["topk_acc"] == [float(np.mean(ranks <= j)) for j in range(10)]
    assert trace["values"].shape == trace["indices"].shape == (len(queries),
                                                              10)
    for sample in got["retrieval_samples"]:
        (sketch, entries), = sample.items()
        i = sketch_paths.index(sketch)
        assert [p for p, _ in entries] == [image_paths[j]
                                           for j in trace["indices"][i]]
        assert [v for _, v in entries] == [float(v)
                                           for v in trace["values"][i]]
    assert trace["rank_s"] > 0
