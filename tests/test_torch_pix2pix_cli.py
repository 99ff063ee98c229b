"""The port's pix2pix CLI against the JAX package's, on the CPU, over a small
synthetic Sketchy corpus at 32 px with the thin nets (``ngf`` = ``ndf`` =
8, the 9-block ResNet generator).

* One set of weights: the port's seeded init written as a reference
  directory (``latest_net_G.pth``, ``latest_net_D.pth``), which the port
  loads natively and JAX's ``cli/port.py::port_pix2pix`` turns into the
  orbax checkpoint JAX's ``--model`` takes.
* ``--mode generate``: the same PNGs, each uint8 level within one of
  JAX's (float32 rounding moves a truncated level by at most one).
* ``--mode train`` with dropout off in both CLIs (the test alone patches
  both packages' ``Pix2PixConfig`` default): the same data, results keys
  and per-epoch losses. Losses at rtol 1e-4 with an absolute 1e-5: after
  Adam's sign-like first step the two packages' parameters part by float
  noise (``tests/test_torch_pix2pix.py``), and JAX runs flax's two-pass
  BatchNorm variance here, the estimator the port uses
  (``tests/test_torch_train_cli.py``).
* Resume: two epochs in one run, and one epoch then ``--continue_train``
  to two, with dropout on, give the same epoch-2 checkpoint bit for bit
  (both nets, both Adam states, the numpy generator).
"""

import functools
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from art_sbir_tpu.cli import pix2pix as jax_cli
from art_sbir_tpu.cli.port import port_pix2pix
from art_sbir_tpu.core.checkpoint import save_pytree
from art_sbir_tpu.data import get_datasets as jax_get_datasets
from art_sbir_tpu.train import gan as JG
from art_sbir_tpu_torch.cli import pix2pix as port_cli
from art_sbir_tpu_torch.data import get_datasets
from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy
from art_sbir_tpu_torch.train.gan import LOSS_KEYS, Pix2Pix, Pix2PixConfig
from tests.torch_threads import two_torch_threads  # noqa: F401

SIZE = 32
THIN = ["--image_size", str(SIZE), "--ngf", "8", "--ndf", "8", "-b", "4",
        "--dataset", "SketchyPix2Pix"]
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)


def _u8(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path), np.int32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_synthetic_sketchy(tmp_path_factory.mktemp("sketchy"),
                                  n_classes=2, photos_per_class=3,
                                  sketches_per_photo=2, size=72)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(reference directory, JAX orbax directory) of one seeded init."""
    d = tmp_path_factory.mktemp("weights")
    ref = d / "pix2pix_ref"
    ref.mkdir()
    model = Pix2Pix(Pix2PixConfig(ngf=8, ndf=8), seed=5, device="cpu")
    torch.save(model.net_g.state_dict(), ref / "latest_net_G.pth")
    torch.save(model.net_d.state_dict(), ref / "latest_net_D.pth")
    save_pytree(d / "jax_orbax", port_pix2pix(ref, "resnet_9blocks", ngf=8,
                                              ndf=8))
    return ref, d / "jax_orbax"


@pytest.fixture(scope="module")
def in_dir(tmp_path_factory):
    """Run ``main(args)`` from a fresh directory (both CLIs write
    ``results/`` and ``models/`` under the working directory)."""
    def run(name, main, args):
        tmp = tmp_path_factory.mktemp(name)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            return main(args), tmp
        finally:
            os.chdir(cwd)
    return run


@pytest.fixture
def no_dropout():
    """Both CLIs' ``Pix2PixConfig`` with dropout off, and flax's two-pass
    BatchNorm variance; the packages themselves are left as they are."""
    import flax.linen.normalization as fnorm

    orig = fnorm._compute_stats

    def two_pass(*args, **kw):
        kw["use_fast_variance"] = False
        return orig(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnorm, "_compute_stats", two_pass)
        mp.setattr(JG, "Pix2PixConfig",
                   functools.partial(JG.Pix2PixConfig, use_dropout=False))
        mp.setattr(port_cli, "Pix2PixConfig",
                   functools.partial(Pix2PixConfig, use_dropout=False))
        yield


def test_sketchy_pix2pix_rows_match_jax(corpus):
    for side in (0, 1):
        got = get_datasets("SketchyPix2Pix", size=1.0, root=corpus)[side]
        want = jax_get_datasets("SketchyPix2Pix", size=1.0,
                                root=corpus)[side]
        assert len(got) == len(want) > 0
        assert [got.item(i) for i in range(len(got))] == \
            [want.item(i) for i in range(len(want))]
        assert got.state_dict == want.state_dict
        assert got.state_dict["augmentation"] == "train_random_hflip"


def test_generate_matches_jax(corpus, weights, in_dir):
    ref, orbax_dir = weights
    out = {}
    for side, main, model, extra in (
            ("jax", jax_cli.main, orbax_dir, []),
            ("port", port_cli.main, ref, ["--device", "cpu"])):
        stats, tmp = in_dir(f"gen_{side}", main, [
            "--mode", "generate", "--data_root", str(corpus), "--model",
            str(model), "--out_dir", "sketches", *THIN, *extra])
        out[side] = {p.name: _u8(p)
                     for p in sorted((tmp / "sketches").glob("*.png"))}
    assert sorted(out["port"]) == sorted(out["jax"])
    assert len(out["port"]) == 6  # one a photo
    for name, img in out["port"].items():
        assert img.shape == (SIZE, SIZE)
        assert np.abs(img - out["jax"][name]).max() <= 1, name
    n_items = sum(len(c) for c in get_datasets("SketchyPix2Pix", size=1.0,
                                               root=corpus))
    assert stats["images"] == n_items  # a photo per sketch, as JAX writes
    assert all(stats[k] >= 0 for k in ("decode_s", "forward_s", "write_s",
                                       "wall_s"))


def _read(folder: Path) -> dict:
    return {name: json.loads((folder / f"{name}.json").read_text())
            for name in ("data_params", "training", "training_params",
                         "inference")}


def test_train_matches_jax(corpus, weights, in_dir, no_dropout):
    """Two epochs, the first the warm-up, from the same weights."""
    ref, orbax_dir = weights
    common = ["--mode", "train", "-e", "2", "--data_root", str(corpus),
              *THIN]
    _, jtmp = in_dir("train_jax", jax_cli.main,
                     common + ["--model", str(orbax_dir)])
    folder, ptmp = in_dir("train_port", port_cli.main,
                          common + ["--model", str(ref), "--device", "cpu"])
    (jfolder,) = (jtmp / "results").iterdir()
    assert folder.name.startswith("Pix2PixModel_SketchyDatasetPix2Pix_")
    got, want = _read(ptmp / folder), _read(jfolder)
    assert got["data_params"] == want["data_params"]
    assert got["training_params"] == want["training_params"]
    assert got["inference"] == want["inference"] == {}
    assert set(got["training"]) == set(want["training"])
    series = got["training"]["train_losses"]
    assert set(series) == set(LOSS_KEYS) == set(
        want["training"]["train_losses"])
    for k in LOSS_KEYS:
        assert len(series[k]) == 2 and np.isfinite(series[k]).all(), k
        np.testing.assert_allclose(series[k],
                                   want["training"]["train_losses"][k],
                                   **LOSS_TOL, err_msg=k)
    assert all(series[k][0] == 0.0 for k in ("G_GAN", "G_L1", "G_total"))
    assert all(series[k][1] > 0.0 for k in ("G_GAN", "G_L1", "G_total"))
    assert (ptmp / folder / "samples.png").is_file()
    export = ptmp / "models" / f"{folder.name}.pt"
    sd = torch.load(export, weights_only=True)
    assert set(sd) == {"G", "D"}

    # the export is a --model of its own
    stats, tmp = in_dir("gen_from_export", port_cli.main, [
        "--mode", "generate", "--data_root", str(corpus), "--model",
        str(export), "--out_dir", "out", "--device", "cpu", *THIN])
    assert len(list((tmp / "out").glob("*.png"))) == 6


def test_continue_train_reproduces_two_epochs(corpus, weights, tmp_path,
                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    common = ["--mode", "train", "--data_root", str(corpus), "--model",
              str(weights[0]), "--device", "cpu", *THIN]
    port_cli.main(common + ["-e", "2", "--checkpoint_dir", "whole"])
    port_cli.main(common + ["-e", "1", "--checkpoint_dir", "split"])
    port_cli.main(common + ["-e", "2", "--checkpoint_dir", "split",
                            "--continue_train"])
    whole = torch.load(tmp_path / "whole" / "2.pt", weights_only=True)
    split = torch.load(tmp_path / "split" / "2.pt", weights_only=True)
    assert whole["numpy_rng"] == split["numpy_rng"]
    for side in ("g", "d"):
        for part in ("model", "optimizer"):
            a, b = whole[side][part], split[side][part]
            if part == "optimizer":
                a, b = a["state"], b["state"]
                assert a.keys() == b.keys() and a
            for k in a:
                for x, y in (zip(a[k].values(), b[k].values())
                             if part == "optimizer" else [(a[k], b[k])]):
                    assert torch.equal(x, y), (side, part, k)


def test_entry_point_needs_a_card_or_cpu(corpus, weights, tmp_path,
                                         monkeypatch):
    """Without ``--device cpu`` and a card, both modes raise before any
    work; generate mode over several data indices exits, and an orbax
    directory exits naming its ROADMAP item."""
    monkeypatch.chdir(tmp_path)
    base = ["--data_root", str(corpus), *THIN]
    if not torch.cuda.is_available():
        for mode in ("generate", "train"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                port_cli.main(["--mode", mode, *base])
        assert not (tmp_path / "data").exists()
        assert not (tmp_path / "results").exists()
    # --tp_devices runs in both modes (tests/test_torch_tp_pix2pix_cli.py);
    # generate runs on one data index
    with pytest.raises(SystemExit, match="generate runs on one data index"):
        port_cli.main(["--tp_devices", "2", "--n_devices", "2", *base,
                       "--device", "cpu"])
    with pytest.raises(SystemExit, match="scripts/orbax_to_pt.py"):
        port_cli.main(["--model", str(weights[1]), *base, "--device", "cpu"])
