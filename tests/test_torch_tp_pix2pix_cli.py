"""The port's tensor-parallel ``cli/pix2pix.py`` on the CPU against one
process.

* ``--mode train --tp_devices 2 --device cpu`` (a 1 x 2 grid of gloo
  ranks; two epochs: the D-only warm-up, then G+D with the U-Net's
  dropout on) against one process: the loss series at JAX's bound (rel
  1e-4, abs 1e-5), and ``models/<run>.pt`` in one device's layout.
* ``--mode generate --tp_devices 2`` from that export: the same PNGs as
  one process, but for a level where a float32 sum lands on a rounding
  edge (at most one level, in under 0.1% of the pixels).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from art_sbir_tpu_torch.cli import pix2pix as port_pix
from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy
from tests.torch_threads import two_torch_threads  # noqa: F401

PIX = ["--ngf", "8", "--ndf", "8", "--image_size", "256", "-b", "4",
       "--netG", "unet_256", "--device", "cpu"]


def _in(tmp: Path, fn, argv):
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        return fn(argv)
    finally:
        os.chdir(cwd)


def test_pix2pix_cli_tp_matches_one_process(tmp_path):
    root = make_synthetic_sketchy(tmp_path / "sketchy", n_classes=2,
                                  photos_per_class=4, sketches_per_photo=1,
                                  size=256)
    runs = {}
    for tag, extra in (("one", []), ("tp", ["--tp_devices", "2"])):
        (tmp_path / tag).mkdir()
        folder = _in(tmp_path / tag, port_pix.main, PIX + [
            "--mode", "train", "-e", "2",
            "--data_root", str(root)] + extra)
        runs[tag] = json.loads((tmp_path / tag / folder / "training.json")
                               .read_text())["train_losses"]
        (runs[tag + "_model"],) = (tmp_path / tag / "models").glob("*.pt")
    for k, series in runs["one"].items():
        assert len(series) == 2
        np.testing.assert_allclose(runs["tp"][k], series, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    one = torch.load(runs["one_model"], weights_only=True)
    tp = torch.load(runs["tp_model"], weights_only=True)
    assert {(n, k): v.shape for n in one for k, v in one[n].items()} == {
        (n, k): v.shape for n in tp for k, v in tp[n].items()}

    for tag, extra in (("gen_one", []), ("gen_tp", ["--tp_devices", "2"])):
        (tmp_path / tag).mkdir()
        _in(tmp_path / tag, port_pix.main, PIX + [
            "--mode", "generate", "--model", str(runs["tp_model"]),
            "--data_root", str(root), "--out_dir", "out"] + extra)
    pngs = sorted(p.name for p in (tmp_path / "gen_one" / "out").iterdir())
    assert pngs and pngs == sorted(
        p.name for p in (tmp_path / "gen_tp" / "out").iterdir())
    for name in pngs:
        a, b = (np.asarray(Image.open(tmp_path / t / "out" / name),
                           np.int16) for t in ("gen_one", "gen_tp"))
        assert np.abs(a - b).max() <= 1, name
        assert (a != b).mean() < 1e-3, name
