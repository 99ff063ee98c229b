"""The port's stroke data against the JAX package's, on the CPU: the
rasterizer, the native binding, the SVG handling, the synthetic SVG
corpus and the stroke catalogs. Everything here is exact: canvases,
points, strings, files and catalog rows are compared bit for bit.

* ``rasterize_strokes`` and ``rasterize_prepared`` against JAX's and
  against JAX's numpy oracle (``ops/raster_reference.py``), on stroke-5
  (the end token at row 0, mid-sequence and absent; integer deltas that
  land on integers; degenerate ranges, which the oracle divides by zero
  on, so those against JAX only) and stroke-3 input.
* The port's ctypes binding of ``native/raster.cpp`` against JAX's.
* ``parse_svg`` (and its JSON cache), ``build_svg``,
  ``reshape_vector_sketch`` and ``reduce_strokes`` against JAX's.
* ``make_synthetic_sketchy(with_svg=True)`` writes JAX's files byte for
  byte.
* VectorizedSketchyV1 (svg and jpg) and QuickdrawV1: every row and the
  ``state_dict`` against JAX's, each package parsing its own copy.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.data import get_datasets as jax_get_datasets
from art_sbir_tpu.data.synthetic import (
    make_synthetic_sketchy as jax_make_sketchy)
from art_sbir_tpu.ops import raster_native as JN
from art_sbir_tpu.ops import raster_reference as RR
from art_sbir_tpu.ops import rasterize as JR
from art_sbir_tpu.ops import svg as JS
from art_sbir_tpu_torch.data import get_datasets
from art_sbir_tpu_torch.data import strokes as PS
from art_sbir_tpu_torch.data.synthetic import (make_synthetic_quickdraw,
                                               make_synthetic_sketchy)
from art_sbir_tpu_torch.ops import raster_native as PN
from art_sbir_tpu_torch.ops import rasterize as PR
from art_sbir_tpu_torch.ops import svg as PSV
from tests.torch_threads import two_torch_threads  # noqa: F401

T = 40


def _stroke5(rng, n_valid, t=T, scale=12.0):
    s = np.zeros((t, 5), np.float32)
    s[:, :2] = rng.standard_normal((t, 2)) * scale
    s[:, 3] = rng.random(t) < 0.15
    s[:, 2] = 1 - s[:, 3]
    s[n_valid - 1, 2:] = [0, 0, 1]
    s[n_valid:] = 0
    s[n_valid:, 4] = 1
    return s


def _cases():
    """(oracle-safe stroke-5 batch, degenerate stroke-5 batch)."""
    rng = np.random.default_rng(3)
    safe = [_stroke5(rng, n) for n in (9, 20, 33)]
    safe.append(_stroke5(rng, T)[:, :])  # end on the last row
    absent = _stroke5(rng, T)
    absent[:, 4] = 0
    absent[-1, 2:4] = [1, 0]
    safe.append(absent)  # no end token at all
    row0 = _stroke5(rng, T)
    row0[0, 2:] = [0, 0, 1]  # an end at row 0 counts as none
    safe.append(row0)
    ints = _stroke5(rng, 25)
    ints[:25, :2] = rng.integers(-13, 14, (25, 2))  # landings on integers
    safe.append(ints)
    flat = _stroke5(rng, 12)
    flat[:, :2] = 0.0  # zero range on both axes
    vertical = _stroke5(rng, 15)
    vertical[:, 0] = 0.0  # zero range on x
    return np.stack(safe), np.stack([flat, vertical])


def _stroke3(rng, b=4, t=20):
    s3 = np.zeros((b, t, 3), np.float32)
    s3[..., :2] = rng.standard_normal((b, t, 2)) * 15
    s3[..., 2] = rng.random((b, t)) < 0.2
    s3[:, -1, 2] = 1
    return s3


def test_rasterize_strokes_stroke5_matches_jax_and_oracle():
    safe, degenerate = _cases()
    batch = np.concatenate([safe, degenerate])
    got = PR.rasterize_strokes(torch.from_numpy(batch)).numpy()
    want = np.asarray(JR.rasterize_strokes(jnp.asarray(batch)))
    assert got.dtype == np.float32 and set(np.unique(got)) <= {0.0, 255.0}
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:len(safe)],
                                  RR.batch_rasterize_relative_np(safe))
    pts_p, seg_p = PR.prepare_points(torch.from_numpy(batch))
    pts_j, seg_j = JR.prepare_points(jnp.asarray(batch))
    np.testing.assert_array_equal(pts_p.numpy(), np.asarray(pts_j))
    np.testing.assert_array_equal(seg_p.numpy(), np.asarray(seg_j))
    assert pts_p.dtype == torch.int32


def test_rasterize_strokes_stroke3_matches_jax_and_oracle():
    s3 = _stroke3(np.random.default_rng(4))
    got = PR.rasterize_strokes(torch.from_numpy(s3)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        JR.rasterize_strokes(jnp.asarray(s3))))
    np.testing.assert_array_equal(got, RR.batch_rasterize_relative_np(s3))


def test_rasterize_prepared_matches_jax_and_oracle():
    safe, degenerate = _cases()
    batch = np.concatenate([safe, degenerate])
    pts_p, seg_p = PR.prepare_points_host(batch)
    pts_j, seg_j = JR.prepare_points_host(batch)
    np.testing.assert_array_equal(pts_p, pts_j)
    np.testing.assert_array_equal(seg_p, seg_j)
    got = PR.rasterize_prepared(torch.from_numpy(pts_p),
                                torch.from_numpy(seg_p)).numpy()
    want = jax.jit(JR.rasterize_prepared)(jnp.asarray(pts_j),
                                          jnp.asarray(seg_j))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got[:len(safe)],
                                  RR.batch_rasterize_relative_np(safe))


def test_bresenham_coverage_matches_generator():
    """JAX ``tests/test_ops_rasterize.py``: the dense coverage test draws
    the sequential Bresenham's pixels, at every direction and slope."""
    rng = np.random.default_rng(9)
    segs = rng.integers(1, 64, size=(60, 4))
    segs[:4] = [[5, 5, 5, 40], [40, 5, 5, 5], [9, 9, 30, 30], [30, 9, 9, 30]]
    pts = torch.from_numpy(segs.reshape(60, 2, 2).astype(np.int32))
    masks = PR.rasterize_points(pts, torch.ones(60, 1, dtype=torch.bool),
                                side=64).numpy()
    for (x0, y0, x1, y1), mask in zip(segs, masks):
        ref = np.zeros((64, 64), bool)
        for x, y in RR.bresenham_points(int(x0), int(y0), int(x1), int(y1)):
            if 0 < x < 64 and 0 < y < 64:
                ref[y, x] = True
        np.testing.assert_array_equal(mask, ref)


def test_native_binding_matches_jax():
    if not JN.available():  # decided here, not at collection
        pytest.skip("g++ missing")
    safe, _ = _cases()
    s3 = _stroke3(np.random.default_rng(5))
    for batch in (safe, s3):
        got = PN.rasterize_batch_native(batch)
        np.testing.assert_array_equal(got, JN.rasterize_batch_native(batch))
        np.testing.assert_array_equal(
            got, PR.rasterize_strokes(torch.from_numpy(batch)).numpy())
    assert PN.load() is PN.load()


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same small Sketchy corpus with SVGs written by each package."""
    tmp = tmp_path_factory.mktemp("svg_corpora")
    kw = dict(n_classes=3, photos_per_class=3, sketches_per_photo=2,
              size=64, with_svg=True)
    return (make_synthetic_sketchy(tmp / "port", **kw),
            jax_make_sketchy(tmp / "jax", **kw))


def test_with_svg_corpus_is_jax_byte_for_byte(corpora):
    port, jax_root = corpora
    files = sorted(p.relative_to(port) for p in port.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(jax_root)
                           for p in jax_root.rglob("*") if p.is_file())
    assert sum(p.suffix == ".svg" for p in files) == 18
    for rel in files:
        assert (port / rel).read_bytes() == (jax_root / rel).read_bytes(), rel


def test_svg_functions_match(corpora, tmp_path):
    port, _ = corpora
    for i, svg in enumerate(sorted(port.rglob("*.svg"))[:6]):
        out_p, out_j = tmp_path / f"p{i}", tmp_path / f"j{i}"
        out_p.mkdir(), out_j.mkdir()
        for reduce_factor, max_length in ((1, 100), (2, 12)):
            got = PSV.parse_svg(svg, out_p, reduce_factor, max_length)
            want = JS.parse_svg(svg, out_j, reduce_factor, max_length)
            assert got == want
            assert ((out_p / f"{svg.stem}.json").read_bytes()
                    == (out_j / f"{svg.stem}.json").read_bytes())
            assert PSV.load_vector_sketch(out_p / f"{svg.stem}.json") == \
                JS.load_vector_sketch(out_j / f"{svg.stem}.json")
            r_p = PSV.reshape_vector_sketch(got)
            r_j = JS.reshape_vector_sketch(want)
            np.testing.assert_array_equal(r_p["image"], r_j["image"])
            assert ({k: v for k, v in r_p.items() if k != "image"}
                    == {k: v for k, v in r_j.items() if k != "image"})
    rows = [[1.0, 2.0, 1, 0, 0], [0.5, -1.0, 1, 0, 0], [3.0, 3.0, 0, 1, 0],
            [1.25, 0.0, 1, 0, 0], [2.0, 2.0, 1, 0, 0], [0.0, 1.0, 1, 0, 0]]
    for factor, max_length in ((1, 0), (2, 0), (2, 3), (3, 2)):
        assert PSV.reduce_strokes([r[:] for r in rows], factor, max_length) \
            == JS.reduce_strokes([r[:] for r in rows], factor, max_length)
    s5 = _cases()[0][1]
    assert PSV.build_svg(s5, (256, 256), tmp_path / "p.svg") == \
        JS.build_svg(s5, (256, 256), tmp_path / "j.svg")
    assert (tmp_path / "p.svg").read_bytes() == (tmp_path / "j.svg").read_bytes()


def test_stroke_utilities_match():
    from art_sbir_tpu.data import strokes as JSt

    rng = np.random.default_rng(6)
    seqs = [rng.standard_normal((n, 3)).astype(np.float32) * 900
            for n in (5, 11, 30, 101)]
    kept_p, idx_p = PS.purify(seqs, 100)
    kept_j, idx_j = JSt.purify(seqs, 100)
    assert idx_p == idx_j == [1, 2]
    for a, b in zip(PS.normalize(kept_p), JSt.normalize(kept_j)):
        np.testing.assert_array_equal(a, b)
    s3 = np.asarray(kept_p[0])
    s3[:, 2] = s3[:, 2] > 0
    np.testing.assert_array_equal(PS.stroke3_to_padded5(s3, 20),
                                  JSt.stroke3_to_padded5(s3, 20))
    s5 = _cases()[0][0][:9]
    np.testing.assert_array_equal(PS.padded5_with_final_end(s5, 20),
                                  JSt.padded5_with_final_end(s5, 20))


def _rows(catalog):
    rows = []
    for i in range(len(catalog)):
        it = catalog.item(i)
        rows.append({k: (v.tolist() if isinstance(v, np.ndarray) else
                         str(v) if k.endswith("path") else v)
                     for k, v in it.items()})
    return rows


@pytest.mark.parametrize("img_format", ["svg", "jpg"])
def test_vectorized_sketchy_rows_match(corpora, tmp_path, img_format):
    """Each package parses its own copy of the corpus (the JSON caches it
    writes are the same text, but for the copy's root in each SVG's
    path), then the port loads JAX's cache too."""
    port, _ = corpora
    roots = {}
    for side in ("port", "jax"):
        roots[side] = tmp_path / side
        shutil.copytree(port, roots[side],
                        ignore=shutil.ignore_patterns("sketch_vectors_*"))
    kw = dict(size=1.0, img_format=img_format, max_erase_count=1)
    got = get_datasets("VectorizedSketchyV1", root=roots["port"], **kw)
    want = jax_get_datasets("VectorizedSketchyV1", root=roots["jax"], **kw)
    cache = "sketch_vectors_100_2_V2"
    for js in sorted((roots["jax"] / cache).rglob("*.json")):
        rel = js.relative_to(roots["jax"])
        # the cache names its SVG by path: each copy's own root
        assert (roots["port"] / rel).read_text() == js.read_text().replace(
            str(roots["jax"]), str(roots["port"])), rel
    cached = get_datasets("VectorizedSketchyV1", root=roots["jax"], **kw)
    for g, c, w in zip(got, cached, want):
        assert len(g) == len(w) > 0
        rows = _rows(w)
        for r in rows:
            if "photo_path" in r:
                r["photo_path"] = r["photo_path"].replace(
                    str(roots["jax"]), str(roots["port"]))
        assert _rows(g) == rows
        assert g.state_dict == w.state_dict
        assert _rows(c) == _rows(w) and c.state_dict == w.state_dict
        assert ("raster_points" in g.item(0)) == (img_format == "svg")


def test_quickdraw_rows_match(tmp_path):
    root = make_synthetic_quickdraw(tmp_path / "quick_draw", n_train=12,
                                    n_valid=4)
    for size in (1.0, 0.5):
        got = get_datasets("QuickdrawV1", size=size, root=root)
        want = jax_get_datasets("QuickdrawV1", size=size, root=root)
        for g, w in zip(got, want):
            assert len(g) == len(w) > 0
            assert _rows(g) == _rows(w)
            assert g.state_dict == w.state_dict
