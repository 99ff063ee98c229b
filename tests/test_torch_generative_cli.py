"""The port's forward-only generator CLIs against the JAX package's, on the
CPU, over small synthetic corpora: ``cli/drawings.py`` (both corpora, and
``--bf16``), ``cli/artwork_gen.py``, ``cli/transformations.py`` (``dilate``
and ``test_transform``), and ``UnpairedImageCatalog``.

Both packages load the same reference-layout ``.pth`` files, written from
the port's seeded init. Decoding is the same on both sides (the native
pipeline or PIL, bit for bit), so the generators see the same pixels; the
float32 forwards differ by rounding only, which moves a truncated uint8
level by at most one.
"""

import random
from pathlib import Path

import numpy as np
import pytest
import torch

from art_sbir_tpu.cli import artwork_gen as jax_artwork
from art_sbir_tpu.cli import drawings as jax_drawings
from art_sbir_tpu.cli import transformations as jax_transformations
from art_sbir_tpu.data import get_datasets as jax_get_datasets
from art_sbir_tpu.data.unpaired import UnpairedImageCatalog as JaxUnpaired
from art_sbir_tpu_torch.cli import artwork_gen, drawings, transformations
from art_sbir_tpu_torch.data import get_datasets
from art_sbir_tpu_torch.data.synthetic import (make_synthetic_kaggle,
                                               make_synthetic_sketchy)
from art_sbir_tpu_torch.data.unpaired import UnpairedImageCatalog
from art_sbir_tpu_torch.models.adain_net import AdaINDecoder, AdaINEncoder
from art_sbir_tpu_torch.models.drawing import DrawingGenerator
from art_sbir_tpu_torch.models.layers import flax_init

SIZE = 64


def _u8(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path), np.int32)


def _tree(root: Path) -> dict:
    """{path relative to root: pixels} of every image under root."""
    return {p.relative_to(root): _u8(p) for p in sorted(root.rglob("*"))
            if p.is_file()}


def _corpora(base: Path) -> dict:
    """The same small Kaggle and Sketchy corpora for each package (each CLI
    writes its drawings into its corpus)."""
    roots = {}
    for side in ("jax", "port"):
        roots[side] = (
            make_synthetic_kaggle(base / side / "kaggle", n_train=6, n_test=2,
                                  size=SIZE, sketch_types=()),
            make_synthetic_sketchy(base / side / "sketchy", n_classes=2,
                                   photos_per_class=2, size=SIZE))
    return roots


@pytest.fixture(scope="module")
def drawing_runs(tmp_path_factory):
    """Both CLIs over both corpora from one ``.pth``; the port also with
    ``--bf16``."""
    base = tmp_path_factory.mktemp("drawings")
    pth = base / "contour.pth"
    torch.save(flax_init(DrawingGenerator(), seed=0).state_dict(),
               pth)
    roots = _corpora(base)
    common = ["--image_size", str(SIZE), "-b", "4", "--model", str(pth)]
    stats = {}
    for corpus, i in (("kaggle", 0), ("sketchy", 1)):
        jax_drawings.main(["--corpus", corpus, "--data_root",
                           str(roots["jax"][i])] + common)
        stats[corpus] = drawings.main(
            ["--corpus", corpus, "--data_root", str(roots["port"][i]),
             "--device", "cpu"] + common)
    drawings.main(["--corpus", "kaggle", "--data_root",
                   str(roots["port"][0]), "--device", "cpu", "--bf16",
                   "--name", "anime"] + common)
    return roots, stats


@pytest.mark.parametrize("corpus,i,n", [("kaggle", 0, 8), ("sketchy", 1, 4)])
def test_drawings_cli_matches_jax(drawing_runs, corpus, i, n):
    """The same files (Sketchy's in one folder a class), mode L at 64 px,
    each uint8 level within one of JAX's."""
    roots, stats = drawing_runs
    got = _tree(roots["port"][i] / "contour_drawings")
    want = _tree(roots["jax"][i] / "contour_drawings")
    assert sorted(got) == sorted(want) and len(got) == n
    if corpus == "sketchy":
        assert {p.parent.name for p in got} == {"class00", "class01"}
    for name, img in got.items():
        assert img.shape == (SIZE, SIZE)
        assert np.abs(img - want[name]).max() <= 1, name
    assert stats[corpus]["images"] == n
    assert all(stats[corpus][k] >= 0 for k in ("decode_s", "forward_s",
                                                "write_s", "wall_s"))


def test_drawings_cli_bf16_close_to_float32(drawing_runs):
    """``--bf16`` against float32: JAX's own bound, a mean absolute
    difference under 6 levels an image
    (``tests/test_cli_generative.py:71-94``)."""
    root = drawing_runs[0]["port"][0]
    f32 = _tree(root / "contour_drawings")
    b16 = _tree(root / "anime_drawings")
    assert sorted(f32) == sorted(b16)
    diffs = [np.abs(f32[k] - b16[k]).mean() for k in f32]
    assert max(diffs) < 6.0, diffs


def test_drawings_model_flag(tmp_path):
    """A port ``.pt`` loads as a ``.pth`` does; an orbax directory is
    refused, naming the converter."""
    from art_sbir_tpu_torch.core.checkpoint import save_state_dict

    sd = flax_init(DrawingGenerator(), seed=4).state_dict()
    save_state_dict(tmp_path / "g.pt", sd)
    gen = drawings.load_generator(str(tmp_path / "g.pt"), torch.device("cpu"))
    assert all(torch.equal(v, sd[k]) for k, v in gen.state_dict().items())
    with pytest.raises(SystemExit, match="scripts/orbax_to_pt.py"):
        drawings.load_generator(str(tmp_path), torch.device("cpu"))


def _he_init(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Conv weights N(0, 2 / fan_in) and zero biases from numpy: through the
    AdaIN networks' 18 convs without norms, the fresh init (variance
    1 / fan_in, halved by each ReLU) shrinks the signal to the last bias,
    and every output would be one colour."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                w = mod.weight
                std = np.sqrt(2.0 / w[0].numel())
                w.copy_(torch.from_numpy(
                    (std * rng.standard_normal(w.shape)).astype(np.float32)))
                mod.bias.zero_()
    return model


@pytest.fixture(scope="module")
def adain_pair(tmp_path_factory):
    """A directory holding ``vgg_normalised.pth`` (the encoder's keys, and a
    deeper conv the loaders must drop) and ``decoder.pth``."""
    d = tmp_path_factory.mktemp("adain")
    vgg = _he_init(AdaINEncoder(), 0).state_dict()
    vgg["32.weight"] = torch.zeros(512, 512, 3, 3)  # relu4_2's conv
    vgg["32.bias"] = torch.zeros(512)
    torch.save(vgg, d / "vgg_normalised.pth")
    torch.save(_he_init(AdaINDecoder(), 1).state_dict(), d / "decoder.pth")
    return d


def test_artwork_gen_cli_matches_jax(tmp_path, adain_pair):
    """The same files, each content image paired with the style that
    ``random.Random(seed).choice`` draws, and the decoded JPEGs within 0.5
    levels of JAX's on average, with under 5% of the values more than 2
    levels apart. The uint8 images agree within a level before the JPEG
    encoder; a one-level step can move a quantized coefficient of an 8x8
    block to its next step, which spreads over the block (on the CPU
    these inputs read at most 0.18 levels on average, 2.1% of the values
    past 2, 18 levels at worst). A style paired wrongly moves an image by
    tens of levels on average (these outputs' spread is about 88)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    content, style = tmp_path / "content", tmp_path / "style"
    content.mkdir()
    style.mkdir()
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (80, 72, 3), np.uint8)).save(
            content / f"c{i}.jpg")
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), np.uint8)).save(
            style / f"s{i}.png")
    args = ["--content_dir", str(content), "--style_dir", str(style),
            "--image_size", str(SIZE), "-b", "3", "--seed", "5", "--alpha",
            "0.7", "--model", str(adain_pair)]
    jax_artwork.main(args + ["--out_dir", str(tmp_path / "jax")])
    stats = artwork_gen.main(args + ["--out_dir", str(tmp_path / "port"),
                                     "--device", "cpu"])
    draw = random.Random(5)
    styles = sorted(style.glob("*.png"))
    assert stats["pairs"] == {f"c{i}": str(draw.choice(styles))
                              for i in range(6)}
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 6
    for name, img in got.items():
        assert img.shape == (SIZE, SIZE, 3)
        diff = np.abs(img - want[name])
        assert diff.mean() < 0.5 and (diff > 2).mean() < 0.05, (
            name, diff.mean(), (diff > 2).mean())


def test_artwork_gen_refuses_an_orbax_directory(tmp_path):
    with pytest.raises(SystemExit, match="scripts/orbax_to_pt.py"):
        artwork_gen.load_adain(str(tmp_path), torch.device("cpu"))


def test_dilate_cli_matches_jax_bit_for_bit(tmp_path):
    """PNGs of mixed (odd) sizes, one at a time: the same files, pixel for
    pixel."""
    from PIL import Image

    rng = np.random.default_rng(1)
    folder = tmp_path / "sketches"
    folder.mkdir()
    for i, (h, w) in enumerate([(31, 45), (64, 64), (17, 9), (50, 33)]):
        img = np.where(rng.random((h, w)) > 0.9, 0, 255).astype(np.uint8)
        img[rng.random((h, w)) > 0.95] = 251
        Image.fromarray(img, mode="L").save(folder / f"s{i}.png")
    want = _tree(jax_transformations.dilate_folder(folder))
    got_dir = transformations.dilate_folder(folder, device="cpu")
    got = _tree(got_dir)
    assert got_dir == tmp_path / "dilated_sketches"
    assert sorted(got) == sorted(want) and len(got) == 4
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])
    transformations.main(["-m", "dilate", "-o", str(folder), "--device",
                          "cpu"])
    assert all(np.array_equal(v, want[k]) for k, v in _tree(got_dir).items())


def test_test_transform_writes_augmented_samples(tmp_path):
    """The random streams differ from JAX's, so the samples are held by
    shape, type and range: four 224 px RGB uint8 images, not all equal to
    the input."""
    from PIL import Image

    rng = np.random.default_rng(2)
    img = np.where(rng.random((96, 80, 3)) > 0.97, 0, 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "sketch.png")
    transformations.main(["-m", "test_transform", "-o",
                          str(tmp_path / "sketch.png"), "--out_dir",
                          str(tmp_path / "out"), "--device", "cpu"])
    outs = sorted((tmp_path / "out").iterdir())
    assert [p.name for p in outs] == [f"transformed_{i}.png" for i in range(4)]
    arrs = [_u8(p) for p in outs]
    for a in arrs:
        assert a.shape == (224, 224, 3) and 0 <= a.min() and a.max() <= 255
    assert len({a.tobytes() for a in arrs}) > 1


# ------------------------------------------------------------------ catalog


@pytest.fixture(scope="module")
def unpaired_roots(tmp_path_factory):
    """Images in nested folders, a second domain of 3, and depth maps of
    which one has no image (dropped) and one matches by ``<stem>.jpg``."""
    from PIL import Image

    base = tmp_path_factory.mktemp("unpaired")
    img = Image.new("RGB", (8, 8))
    for rel in ("a.jpg", "b.png", "sub/c.jpg", "sub/d.JPEG", "e.webp"):
        (base / "root" / rel).parent.mkdir(parents=True, exist_ok=True)
        img.save(base / "root" / rel)
    (base / "root" / "notes.txt").write_text("not an image")
    for rel in ("x.jpg", "y.jpg", "z.png"):
        (base / "root2" / rel).parent.mkdir(parents=True, exist_ok=True)
        img.save(base / "root2" / rel)
    for rel in ("a.png", "b.png", "q.png", "e.webp"):
        (base / "depth" / rel).parent.mkdir(parents=True, exist_ok=True)
        img.save(base / "depth" / rel)
    return base


def _catalog_table(c) -> dict:
    return {"paths": c.paths, "paths2": c.paths2,
            "depth_maps": c.depth_maps, "state_dict": c.state_dict,
            "items": [c.item(i) for i in range(len(c))]}


@pytest.mark.parametrize("kw", [
    {"mode": "test"},
    {"mode": "train", "root2": "root2"},
    {"mode": "train", "root2": "root2", "depth_root": "depth"},
    {"mode": "test", "depth_root": "depth"},
])
def test_unpaired_catalog_matches_jax(unpaired_roots, kw):
    kw = {k: unpaired_roots / v if k.endswith("root") or k == "root2" else v
          for k, v in kw.items()}
    got = _catalog_table(UnpairedImageCatalog(unpaired_roots / "root", **kw))
    want = _catalog_table(JaxUnpaired(unpaired_roots / "root", **kw))
    assert got == want
    assert got["paths"]


def test_get_datasets_unpaired_depth_matches_jax(unpaired_roots):
    kw = dict(root=unpaired_roots / "root", root2=unpaired_roots / "root2",
              depth_root=unpaired_roots / "depth")
    got = [_catalog_table(c) for c in get_datasets("UnpairedDepth", **kw)]
    want = [_catalog_table(c) for c in jax_get_datasets("UnpairedDepth", **kw)]
    assert got == want
    assert got[0]["paths2"] and not got[1]["paths2"]


# ------------------------------------------------------------------ devices


def test_generator_clis_raise_without_cuda(monkeypatch, tmp_path):
    """Without ``--device cpu`` and without a card, each entry point
    refuses to run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "d").mkdir()
    for call in (
            lambda: drawings.main(["--data_root", str(tmp_path)]),
            lambda: artwork_gen.main(["--content_dir", str(tmp_path),
                                      "--style_dir", str(tmp_path)]),
            lambda: transformations.main(["-m", "dilate", "-o",
                                          str(tmp_path / "d")]),
            lambda: transformations.main(["-m", "test_transform", "-o",
                                          str(tmp_path / "s.png")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.cuda
def test_cuda_generators_match_the_cpu(tmp_path):
    """On the card: the drawing generator and style transfer in IEEE
    float32 against the CPU at atol 1e-4, and ``dilate_binarize`` bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.models.adain_net import style_transfer
    from art_sbir_tpu_torch.ops.dilate import dilate_binarize

    ieee_f32()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((2, 3, SIZE, SIZE)).astype(np.float32))
    gen = flax_init(DrawingGenerator(), seed=0).eval()
    enc = flax_init(AdaINEncoder(), seed=0).eval()
    dec = flax_init(AdaINDecoder(), seed=1).eval()
    with torch.no_grad():
        cpu = [gen(x), style_transfer(enc, dec, x, x.flip(0))]
        card = [gen.cuda()(x.cuda()),
                style_transfer(enc.cuda(), dec.cuda(), x.cuda(),
                               x.flip(0).cuda())]
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    img = torch.from_numpy(rng.integers(0, 256, (37, 29), dtype=np.uint8))
    assert torch.equal(dilate_binarize(img.cuda()).cpu(), dilate_binarize(img))
