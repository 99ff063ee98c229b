"""The port's triplet loader, learnable corpus and BatchNorm
recalibration against the JAX package's, on the CPU.

* ``TripletLoader``: the same batches, byte for byte (order over two
  shuffled epochs, labels, the Augmented catalogs' mask), and item 0 in
  place of a corrupt image.
* The learnable corpus: the same files, byte for byte.
* ``recalibrate_from_catalog``: the statistics of both modes within rtol
  1e-4 and an absolute 1e-5, with flax's two-pass variance on the JAX
  side (``tests/test_torch_train_cli.py`` says why both); the model is
  left as it was, and ``embed_fn_per_modality`` embeds with each set.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from art_sbir_tpu.data import get_datasets as jax_get_datasets
from art_sbir_tpu.data.loader import TripletLoader as JaxTripletLoader
from art_sbir_tpu.data.synthetic import make_synthetic_kaggle as jax_kaggle
from art_sbir_tpu.data.synthetic import make_synthetic_sketchy as jax_sketchy
from art_sbir_tpu.train.bn import recalibrate_from_catalog as jax_recal
from art_sbir_tpu_torch.data import get_datasets
from art_sbir_tpu_torch.data.loader import TripletLoader
from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy
from art_sbir_tpu_torch.models import port_weights as PW
from art_sbir_tpu_torch.models.resnet import create_encoder
from art_sbir_tpu_torch.train.bn import (embed_fn_per_modality,
                                        recalibrate_from_catalog)
from tests.test_torch_data import _files
from tests.test_torch_train_cli import (LAYERS, RES, STATS_TOL, WIDTH,  # noqa: F401
                                        init, sketchy_root,
                                        two_pass_variance)


# ------------------------------------------------------------ the loader


def _batches(loader, epochs=2):
    return [b for _ in range(epochs) for b in loader]


@pytest.mark.parametrize("name,root_kind", [("SketchyV1", "sketchy"),
                                            ("SketchyV2", "sketchy"),
                                            ("AugmentedKaggleV2", "kaggle")])
def test_triplet_loader_matches_jax(sketchy_root, tmp_path, name, root_kind):
    root = (sketchy_root if root_kind == "sketchy"
            else jax_kaggle(tmp_path / "kaggle", n_train=10, n_test=4,
                            size=48))
    kw = dict(size=1.0, root=root)
    if root_kind == "kaggle":
        kw.update(sketch_type="contour_drawings", img_type="images")
    jcat = jax_get_datasets(name, **kw)[0]
    pcat = get_datasets(name, **kw)[0]
    want = _batches(JaxTripletLoader(jcat, 4, 32, seed=5))
    got = _batches(TripletLoader(pcat, 4, 32, seed=5))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if name == "AugmentedKaggleV2":
        assert all((b["augment"] == 1).all() for b in got)


def test_triplet_loader_falls_back_to_item_zero(sketchy_root, tmp_path,
                                                capsys):
    """A corrupt image decodes as item 0's positive, with a note."""
    import shutil

    root = tmp_path / "sk"
    shutil.copytree(sketchy_root, root)
    cat = get_datasets("SketchyV1", size=1.0, root=root)[0]
    bad = cat.item(3)["sketch"]
    Path(bad).write_bytes(b"not an image")
    loader = TripletLoader(cat, 4, 32, shuffle=False, prefetch=False)
    batch = next(iter(loader))
    assert f"error decoding {bad}" in capsys.readouterr().out
    np.testing.assert_array_equal(batch["sketch"][3],
                                  loader._decode(cat.item(0)["positive"]))


def test_learnable_corpus_byte_identical(tmp_path):
    kw = dict(n_classes=3, photos_per_class=2, sketches_per_photo=2, size=48,
              learnable=True)
    jax_sketchy(tmp_path / "jax", **kw)
    make_synthetic_sketchy(tmp_path / "port", **kw)
    want = _files(tmp_path / "jax")
    assert len(want) == 18 and _files(tmp_path / "port") == want


# ----------------------------------------------------- BN recalibration


@pytest.mark.parametrize("mode", ["mixed", "per_modality"])
def test_recalibrate_from_catalog_matches_jax(sketchy_root, init, mode):
    model, params, stats, _, pt = init
    jcat = jax_get_datasets("SketchyV1", size=1.0, root=sketchy_root)[0]
    pcat = get_datasets("SketchyV1", size=1.0, root=sketchy_root)[0]
    kw = dict(mode=mode, image_size=RES, resize_mode="shortest_crop",
              batch_size=4, max_batches=3)
    want = jax_recal(model.apply, params, stats, jcat, **kw)
    port = create_encoder(compute_dtype=torch.float32, device="cpu",
                          input_resolution=RES, width=WIDTH, layers=LAYERS)
    port.load_state_dict(torch.load(pt, weights_only=True))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = recalibrate_from_catalog(port, pcat, **kw)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k  # the model is left as it was
    assert not port.training
    if mode == "per_modality":
        embed_s, embed_p = embed_fn_per_modality(port, *got)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, RES, RES, 3)).astype(np.float32))
        for embed, stats in ((embed_s, got[0]), (embed_p, got[1])):
            ref = create_encoder(compute_dtype=torch.float32, device="cpu",
                                 input_resolution=RES, width=WIDTH,
                                 layers=LAYERS)
            ref.load_state_dict(port.state_dict())
            ref.load_state_dict(stats, strict=False)
            with torch.no_grad():
                assert torch.equal(embed(x), ref.eval()(x))
    pairs = zip(got, want) if mode == "per_modality" else [(got, want)]
    for g, w in pairs:
        w_sd = PW.modified_resnet_from_flax(params, w, LAYERS)
        assert set(g) == {k for k in w_sd if "running_" in k}
        for k, v in g.items():
            np.testing.assert_allclose(v.numpy(), w_sd[k].numpy(),
                                       **STATS_TOL, err_msg=k)
