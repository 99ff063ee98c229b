"""The port's dataset layer against the JAX package's, on the CPU.

* the sklearn-parity split: the same indices;
* the catalogs on the JAX package's synthetic corpora: the same sketch and
  photo paths, labels, ``state_dict`` and, item by item, the same triplets
  with their negatives drawn in the same order from the same seed;
* decoding: ``GalleryLoader`` batches bit-identical to the JAX package's on
  the PIL backend and on the native one (``native/imgpipe.cpp``, built by
  the port into ``art_sbir_tpu_torch/_build/``);
* the synthetic generators: the same files, byte for byte.
"""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from art_sbir_tpu.data import get_datasets as jax_get_datasets
from art_sbir_tpu.data.loader import GalleryLoader as JaxGalleryLoader
from art_sbir_tpu.data.loader import decode_image as jax_decode_image
from art_sbir_tpu.data.split import split_indices as jax_split_indices
from art_sbir_tpu.data.synthetic import make_synthetic_kaggle as jax_kaggle
from art_sbir_tpu.data.synthetic import make_synthetic_sketchy as jax_sketchy
from art_sbir_tpu_torch.core.config import Registry
from art_sbir_tpu_torch.data import get_datasets, native_loader
from art_sbir_tpu_torch.data.loader import GalleryLoader, decode_paths
from art_sbir_tpu_torch.data.split import split_arrays, split_indices
from art_sbir_tpu_torch.data.synthetic import (make_synthetic_kaggle,
                                               make_synthetic_sketchy)


@pytest.fixture(scope="module")
def sketchy_root(tmp_path_factory):
    return jax_sketchy(tmp_path_factory.mktemp("sketchy"), n_classes=4,
                       photos_per_class=3, sketches_per_photo=3)


@pytest.fixture(scope="module")
def kaggle_root(tmp_path_factory):
    return jax_kaggle(tmp_path_factory.mktemp("kaggle"), n_train=14,
                      n_test=7, sketch_types=("contour_drawings", "anime"))


@pytest.mark.parametrize("n,test_size,seed", [
    (1, 0.1, 42), (18, 0.1, 42), (101, 0.25, 42), (1000, 0.1, 7)])
def test_split_indices_match_jax(n, test_size, seed):
    got, want = split_indices(n, test_size, seed), jax_split_indices(
        n, test_size, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    items = list(range(n))
    assert split_arrays([items], test_size, seed, "test")[0] == [
        items[i] for i in want[1]]


# (name, extra get_datasets kwargs; "@sketchy"/"@kaggle" stand for the roots)
CATALOGS = [
    ("SketchyV1", dict(root="@sketchy")),
    ("SketchyV2", dict(root="@sketchy")),
    ("Sketchy", dict(root="@sketchy", size=0.5)),
    ("KaggleV1", dict(root="@kaggle")),
    ("KaggleV1", dict(root="@kaggle", sketch_type=["contour_drawings",
                                                   "anime"])),
    ("KaggleV2", dict(root="@kaggle")),
    ("AugmentedKaggleV2", dict(root="@kaggle")),
    ("KaggleDatasetImgOnlyV2", dict(root="@kaggle")),
    ("KaggleInferenceV1", dict(root="@kaggle", sketch_type="sketches")),
    ("MixedDatasetV1", dict(root_kaggle="@kaggle", root_sketchy="@sketchy")),
    ("MixedDatasetV2", dict(root_kaggle="@kaggle", root_sketchy="@sketchy")),
    ("CategorizedMixedDatasetV2", dict(root_kaggle="@kaggle",
                                       root_sketchy="@sketchy")),
]


def _plain(v):
    """Paths as strings, recursively, so that dicts compare by value."""
    if isinstance(v, Path):
        return str(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _table(cat):
    """Everything a catalog exposes, with its triplets drawn in order."""
    if cat is None:
        return None
    out = {"len": len(cat), "state_dict": cat.state_dict,
           "sketch_paths": cat.sketch_paths,
           "photo_paths": getattr(cat, "photo_paths", None),
           "labels": getattr(cat, "labels", None),
           "resize_mode": getattr(cat, "resize_mode", None)}
    if hasattr(cat, "item"):
        out["items"] = [cat.item(i) for i in range(len(cat))]
        out["again"] = [cat.item(i) for i in range(min(len(cat), 5))]
    return _plain(out)


@pytest.mark.parametrize("name,kw", CATALOGS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CATALOGS)])
def test_catalogs_match_jax(sketchy_root, kaggle_root, name, kw):
    roots = {"@sketchy": sketchy_root, "@kaggle": kaggle_root}
    kw = {k: roots.get(v, v) if isinstance(v, str) else v
          for k, v in kw.items()}
    kw.setdefault("size", 1.0)
    got = [_table(c) for c in get_datasets(name, **kw)]
    want = [_table(c) for c in jax_get_datasets(name, **kw)]
    assert got == want
    assert got[1]["len"] > 0


def test_generative_catalogs_are_not_registered_yet():
    """The stroke catalogs come with their slice; SketchyPix2Pix came with
    pix2pix (``tests/test_torch_pix2pix_cli.py`` holds its rows)."""
    from art_sbir_tpu_torch.data import DATASETS

    assert "SketchyPix2Pix" in DATASETS
    for name in ("QuickDrawV1", "VectorizedSketchyV1", "UnpairedV1"):
        with pytest.raises(KeyError, match="unknown dataset"):
            get_datasets(name)


def test_registry_rejects_duplicates_and_names_the_known():
    reg = Registry("thing")
    reg.register("a", 1)

    @reg.register("b")
    def b():
        return 2

    assert reg["a"] == 1 and reg["b"] is b and "a" in reg
    assert list(reg) == reg.names() == ["a", "b"]
    with pytest.raises(KeyError, match="duplicate thing"):
        reg.register("a", 3)
    with pytest.raises(KeyError, match="known: a, b"):
        reg["c"]


def _images(sketchy_root, kaggle_root, tmp_path):
    """The corpora's images plus odd shapes, palette, RGBA and grey images
    (both decoders' special cases) and a CMYK JPEG (native rejects it,
    PIL decodes it)."""
    rng = np.random.default_rng(5)
    extra = []
    for i, (h, w) in enumerate([(67, 431), (301, 99)]):
        p = tmp_path / f"odd{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(p)
        extra.append(p)
    arr = rng.integers(0, 256, (90, 140, 3), np.uint8)
    Image.fromarray(arr).convert("P").save(tmp_path / "pal.png")
    Image.fromarray(rng.integers(0, 256, (90, 140, 4), np.uint8),
                    "RGBA").save(tmp_path / "rgba.png")
    Image.fromarray(arr[..., 0], "L").save(tmp_path / "gray.png")
    Image.fromarray(arr).convert("CMYK").save(tmp_path / "cmyk.jpg")
    extra += [tmp_path / n for n in ("pal.png", "rgba.png", "gray.png",
                                     "cmyk.jpg")]
    return (sorted(Path(sketchy_root).rglob("*.jpg"))[:6]
            + sorted(Path(sketchy_root).rglob("*.png"))[:6]
            + sorted(Path(kaggle_root).rglob("*.jpg"))[:4] + extra)


@pytest.mark.parametrize("backend", ["pil", "native", "auto"])
@pytest.mark.parametrize("mode", ["square", "shortest_crop"])
def test_gallery_loader_matches_jax(sketchy_root, kaggle_root, tmp_path,
                                    backend, mode):
    if backend == "native" and not native_loader.available():
        pytest.skip("libimgpipe does not build here (g++, libjpeg or "
                    "libpng missing)")
    paths = _images(sketchy_root, kaggle_root, tmp_path)
    want = JaxGalleryLoader(paths, 48, mode, decode_backend="pil")
    got = GalleryLoader(paths, 48, mode, decode_backend=backend)
    assert len(got) == len(want) == len(paths)
    for start, count in ((0, len(paths)), (3, 5), (len(paths) - 2, 7)):
        np.testing.assert_array_equal(got(start, count), want(start, count))


def test_grayscale_decode_matches_jax(sketchy_root, kaggle_root, tmp_path):
    paths = _images(sketchy_root, kaggle_root, tmp_path)
    want = np.stack([jax_decode_image(p, 40, "shortest_crop", grayscale=True)
                     for p in paths])
    for backend in ("pil", "auto"):
        got = decode_paths(paths, 40, "shortest_crop", grayscale=True,
                           backend=backend)
        np.testing.assert_array_equal(got, want)


def test_native_decoder_is_built_under_the_port(sketchy_root):
    if not native_loader.available():
        pytest.skip("libimgpipe does not build here (g++, libjpeg or "
                    "libpng missing)")
    lib = native_loader.build()
    assert lib.parent == native_loader.BUILD_DIR
    assert lib.parent.name == "_build" and lib.parent.parent.name == \
        "art_sbir_tpu_torch"
    png = sorted(Path(sketchy_root).rglob("*.png"))[:3]
    batch, failed = native_loader.decode_batch_mem(
        [p.read_bytes() for p in png], 32, "square")
    assert failed == []
    for b, p in zip(batch, png):
        np.testing.assert_array_equal(b, jax_decode_image(p, 32, "square"))


def test_decode_paths_rejects_unknown_backend(sketchy_root):
    with pytest.raises(ValueError, match="unknown decode backend"):
        decode_paths([], 32, backend="cv2")


def _files(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_synthetic_sketchy_byte_identical(tmp_path):
    kw = dict(n_classes=2, photos_per_class=2, sketches_per_photo=2, size=40)
    jax_sketchy(tmp_path / "jax", **kw)
    make_synthetic_sketchy(tmp_path / "port", **kw)
    want = _files(tmp_path / "jax")
    assert len(want) == 12 and _files(tmp_path / "port") == want


def test_synthetic_kaggle_byte_identical(tmp_path):
    kw = dict(n_train=5, n_test=4, size=40,
              sketch_types=("contour_drawings", "anime"))
    jax_kaggle(tmp_path / "jax", **kw)
    make_synthetic_kaggle(tmp_path / "port", **kw)
    want = _files(tmp_path / "jax")
    assert len(want) == 34 and _files(tmp_path / "port") == want
