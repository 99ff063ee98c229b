"""The port's Photo2Sketch CLI against the JAX package's, on the CPU, over a
small synthetic Sketchy corpus with SVGs and six synthetic QuickDraw
archives.

* The batch builder (``cli/photo2sketch.py::batches``) in its three
  branches, against JAX's (its closure at JAX ``cli/photo2sketch.py:108-
  130`` restated here with JAX's own functions, since the closure cannot
  be called): ``--img_format jpg`` (``normalize(decode_paths(...))``),
  ``svg`` (``raster_photo_prepared`` of the cached points) and Quickdraw
  (``raster_photo`` of the strokes). The same batches in the same order
  under the same seed: vectors equal, photos at rtol 1e-6 (the port is
  NCHW, transposed here).
* One run of each CLI end to end on the jpg branch at ``--image_size 64``
  with the thin decoder, compared by structure: the files written, the
  JSON keys, the data and training parameters, the loss series' keys and
  lengths, the sample SVGs and JSONs. The losses cannot match: the noise
  differs. ``--model`` with the saved ``.pt`` restores the parameters bit
  for bit; an orbax directory is refused; without a card and without
  ``--device cpu`` the CLI raises. ``--tp_devices 2`` (two gloo ranks)
  gives the one process's loss series at JAX's tensor-parallel bound.
* The svg and Quickdraw branches run end to end only on the card (their
  VGG runs at 256 px): ``chip_smoke.py``'s ``photo2sketch`` phase.
"""

import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.cli import photo2sketch as jax_cli
from art_sbir_tpu.data import get_datasets as jax_get_datasets
from art_sbir_tpu.data.loader import decode_paths as jax_decode_paths
from art_sbir_tpu.ops import rasterize as JR
from art_sbir_tpu.ops.resize import (IMAGENET_MEAN, IMAGENET_STD,
                                     normalize as jax_normalize)
from art_sbir_tpu_torch.cli import photo2sketch as port_cli
from art_sbir_tpu_torch.data import get_datasets
from art_sbir_tpu_torch.data.synthetic import (make_synthetic_quickdraw,
                                               make_synthetic_sketchy)
from art_sbir_tpu_torch.train.vae import LOSS_KEYS, VAEConfig, VAETrainer

SIZE = 64
THIN = ["--image_size", str(SIZE), "--z_size", "8", "--dec_rnn_size", "16",
        "--num_mixture", "3", "--batchsize", "4", "--size", "1.0",
        "--save_rate", "1"]
PHOTO_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sketchy(tmp_path_factory):
    return make_synthetic_sketchy(
        tmp_path_factory.mktemp("p2s") / "sketchy", n_classes=2,
        photos_per_class=3, sketches_per_photo=2, size=SIZE, with_svg=True)


def _jax_photo(raster):
    return jax_normalize(1.0 - raster[..., None].repeat(3, -1) / 255.0,
                         IMAGENET_MEAN, IMAGENET_STD)


def _jax_batches(catalog, train, rng, batch_size, image_size):
    """JAX ``cli/photo2sketch.py:108-130``: (photo NHWC, vectors)."""
    order = list(range(len(catalog)))
    if train:
        rng.shuffle(order)
    for s in range(0, len(order), batch_size):
        items = [catalog.item(i) for i in order[s: s + batch_size]]
        vec = jnp.asarray(np.stack([it["sketch_vector"] for it in items]))
        if "photo_path" in items[0]:
            photos = jax_decode_paths([it["photo_path"] for it in items],
                                      image_size).astype(np.float32) / 255.0
            photo = jax_normalize(jnp.asarray(photos), IMAGENET_MEAN,
                                  IMAGENET_STD)
        elif "raster_points" in items[0]:
            pts = jnp.asarray(np.stack([it["raster_points"] for it in items]))
            segs = jnp.asarray(np.stack([it["raster_segs"] for it in items]))
            photo = _jax_photo(jax.jit(JR.rasterize_prepared)(pts, segs))
        else:
            photo = _jax_photo(JR.rasterize_strokes(vec))
        yield np.asarray(photo), np.asarray(vec)


@pytest.mark.parametrize("branch", ["jpg", "svg", "quickdraw"])
def test_batches_match_jax(sketchy, tmp_path, branch):
    if branch == "quickdraw":
        root = make_synthetic_quickdraw(tmp_path / "quick_draw", n_train=2,
                                        n_valid=1)
        kw = dict(dataset="QuickdrawV1", size=1.0, root=root)
    else:
        root = tmp_path / "sketchy"
        shutil.copytree(sketchy, root)
        kw = dict(dataset="VectorizedSketchyV1", size=1.0, img_format=branch,
                  max_erase_count=1, root=root)
    port_cat = get_datasets(**kw)[0]
    jax_cat = jax_get_datasets(**kw)[0]
    got = list(port_cli.batches(port_cat, True, np.random.default_rng(3), 4,
                                SIZE, torch.device("cpu")))
    want = list(_jax_batches(jax_cat, True, np.random.default_rng(3), 4,
                             SIZE))
    assert len(got) == len(want) >= 2
    side = SIZE if branch == "jpg" else 256  # strokes rasterize at 256
    for g, (photo, vec) in zip(got, want):
        np.testing.assert_array_equal(g["sketch_vector"].numpy(), vec)
        assert g["photo"].shape == (len(vec), 3, side, side)
        np.testing.assert_allclose(g["photo"].permute(0, 2, 3, 1).numpy(),
                                   photo, **PHOTO_TOL)


def _run(cli, cwd: Path, argv) -> Path:
    here = os.getcwd()
    cwd.mkdir()
    os.chdir(cwd)
    try:
        out = cli.main(argv)
    finally:
        os.chdir(here)
    (folder,) = (cwd / "results").iterdir()
    return folder, out


@pytest.fixture(scope="module")
def cli_runs(sketchy, tmp_path_factory):
    """Each CLI once on the jpg branch, over its own copy of the corpus."""
    tmp = tmp_path_factory.mktemp("p2s_cli")
    runs = {}
    for name, cli, extra in (("jax", jax_cli, []),
                             ("port", port_cli, ["--device", "cpu"])):
        root = tmp / f"{name}_data"
        shutil.copytree(sketchy, root)
        runs[name] = _run(cli, tmp / name,
                          THIN + ["--data_root", str(root)] + extra)
    return runs


def _read(folder: Path, name: str) -> dict:
    return json.loads((folder / f"{name}.json").read_text())


def test_cli_run_matches_jax_by_structure(cli_runs):
    (jdir, _), (pdir, out) = cli_runs["jax"], cli_runs["port"]
    assert (sorted(p.name for p in pdir.iterdir())
            == sorted(p.name for p in jdir.iterdir()))
    assert pdir.name.split("_")[:2] == jdir.name.split("_")[:2]
    assert _read(pdir, "data_params") == _read(jdir, "data_params")
    jp, pp = _read(jdir, "training_params"), _read(pdir, "training_params")
    assert set(pp) == set(jp)
    assert {k: v for k, v in pp.items() if k != "data_root"} == {
        k: v for k, v in jp.items() if k != "data_root"}
    want, got = _read(jdir, "training"), _read(pdir, "training")
    assert set(got) == set(want)
    for k in ("train_losses", "test_losses"):
        assert set(got[k]) == set(want[k]) == set(LOSS_KEYS)
        for key in LOSS_KEYS:
            assert len(got[k][key]) == len(want[k][key]) == 1
            assert np.isfinite(got[k][key]).all()
    assert _read(pdir, "inference") == _read(jdir, "inference") == {}
    for svg in sorted(pdir.glob("sample_1_*.json")):
        g, w = json.loads(svg.read_text()), _read(jdir, svg.stem)
        assert g["shape"] == w["shape"] == [256, 256]
        assert np.asarray(g["image"]).shape == np.asarray(w["image"]).shape \
            == (port_cli.SAMPLE_STEPS, 5)
        assert (pdir / f"{svg.stem}.svg").read_text().startswith("<svg")
    assert out["folder"] == Path("results") / pdir.name
    assert (pdir.parents[1] / out["model"]).is_file()
    assert all(out[k] >= 0 for k in ("catalog_s", "batch_s", "step_s",
                                      "samples_s"))


def test_model_flag_restores_the_saved_parameters(cli_runs, tmp_path):
    pdir, out = cli_runs["port"]
    saved = torch.load(pdir.parents[1] / out["model"], weights_only=True)
    trainer = VAETrainer(VAEConfig(z_size=8, dec_rnn_size=16, num_mixture=3,
                                   image_size=SIZE), seed=1, device="cpu")
    port_cli.load_weights(trainer, str(pdir.parents[1] / out["model"]))
    got = trainer.model.state_dict()
    assert set(got) == set(saved)
    assert all(torch.equal(got[k], v) for k, v in saved.items())
    (tmp_path / "orbax").mkdir()
    with pytest.raises(SystemExit, match="scripts/orbax_to_pt.py"):
        port_cli.load_weights(trainer, str(tmp_path / "orbax"))


@pytest.mark.parametrize("flags", [["--tp_devices", "2"]])
def test_mesh_flags_exit(flags, sketchy, cli_runs, tmp_path):
    """No mesh flag exits any longer: ``--tp_devices 2`` trains on a 1 x 2
    grid of gloo ranks and gives the one process's run and its files:
    every loss series within JAX's tensor-parallel bound (rel 1e-4, abs
    1e-5, ``tests/test_sharding.py:472-491``) plus twice the one
    process's own distance between its runs at two threads (``cli_runs``)
    and at the ranks' one. At the default lr Adam's sign-like steps turn
    float32 rounding into test losses 1.6e-4 apart between those two runs
    of one process, past JAX's bound; the train losses lie about 2e-6
    apart, so there the bound is JAX's."""
    runs, n = {}, torch.get_num_threads()
    for name, extra, threads in (("one_t1", [], 1), ("tp", flags, n)):
        root = tmp_path / f"{name}_data"
        shutil.copytree(sketchy, root)
        torch.set_num_threads(threads)
        try:
            runs[name] = _run(port_cli, tmp_path / name, THIN + extra + [
                "--data_root", str(root), "--device", "cpu"])
        finally:
            torch.set_num_threads(n)
    folder, out = runs["tp"]
    pdir, one_out = cli_runs["port"]
    assert (sorted(p.name for p in folder.iterdir())
            == sorted(p.name for p in pdir.iterdir()))
    got, want = _read(folder, "training"), _read(pdir, "training")
    t1 = _read(runs["one_t1"][0], "training")
    for split in ("train_losses", "test_losses"):
        for k in LOSS_KEYS:
            spread = np.abs(np.subtract(t1[split][k], want[split][k]))
            np.testing.assert_array_less(
                np.abs(np.subtract(got[split][k], want[split][k])),
                1e-5 + 1e-4 * np.abs(want[split][k]) + 2 * spread,
                err_msg=f"{split} {k}")
    saved = torch.load(folder.parents[1] / out["model"], weights_only=True)
    one = torch.load(pdir.parents[1] / one_out["model"], weights_only=True)
    assert {k: v.shape for k, v in saved.items()} == {
        k: v.shape for k, v in one.items()}


def test_cli_raises_without_a_card(monkeypatch, sketchy):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(THIN + ["--data_root", str(sketchy)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VAETrainer(VAEConfig())


@pytest.mark.cuda
def test_cuda_batches_match_cpu(sketchy, tmp_path):
    """On the card: the svg and Quickdraw branches' photos equal the CPU's
    bit for bit (``chip_smoke.py``'s ``photo2sketch`` phase runs the CLI
    there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run by chip_smoke.py)")
    root = make_synthetic_quickdraw(tmp_path / "quick_draw", n_train=2,
                                    n_valid=1)
    for kw in (dict(dataset="VectorizedSketchyV1", img_format="svg",
                    root=sketchy),
               dict(dataset="QuickdrawV1", root=root)):
        cat = get_datasets(size=1.0, **kw)[0]
        for dev in ("cpu", "cuda"):
            kw[dev] = [b["photo"].cpu() for b in port_cli.batches(
                cat, False, None, 4, SIZE, torch.device(dev))]
        assert all(torch.equal(a, b) for a, b in zip(kw["cpu"], kw["cuda"]))
