"""The port's data-parallel CLIs on the CPU against one device, and
``cli/compare.py`` and ``cli/data_setup.py`` against the JAX package's.

* ``cli/train.py --n_devices 2 --device cpu`` (two gloo ranks) against
  ``--n_devices 1`` on a synthetic SketchyV1 corpus (21 train triplets)
  at 64 px with the thin encoder and ``--inference``, by JAX's own CLI
  rule (``tests/test_sharding.py:146-153``): train and test losses at
  rtol 2e-3, ``topk_acc`` equal, MRR at rtol 1e-6. Batch 4 leaves a tail
  of one row (tiled to two); batch 5 tiles every batch to ten rows. The
  runs are ``--no-bf16``: on the CPU a bf16 run's losses move by about 1%
  with the thread count alone (1.0216, 1.0118 and 1.0146 at 1, 2 and 4
  threads for batch 4), so two ranks cannot be held to one device there.
* ``--multihost`` in two processes under torchrun's environment (gloo),
  against the same one-device run.
* ``cli/pix2pix.py --mode train`` (two epochs: the D-only warm-up, then
  G+D, dropout on) and ``cli/photo2sketch.py`` (one epoch) with
  ``--n_devices 2 --device cpu`` against one device: every loss series
  at JAX's step bound (rtol 1e-5, absolute 1e-6), ``n_devices`` recorded.
* ``cli/compare.py`` on ``tests/test_cli_compare.py``'s cases: the same
  table as JAX's CLI, and a chart.
* ``cli/data_setup.py --synthetic`` writes JAX's files byte for byte, and
  ``--kaggle_split`` on a synthetic ``all_data_info.csv`` (NA cells, rare
  genres and styles) writes JAX's CSV splits byte for byte.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from art_sbir_tpu_torch.cli import compare as port_compare
from art_sbir_tpu_torch.cli import data_setup as port_setup
from art_sbir_tpu_torch.cli import photo2sketch as port_p2s
from art_sbir_tpu_torch.cli import pix2pix as port_pix
from art_sbir_tpu_torch.cli import train as port_train
from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy
from tests.torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
THIN = ["--image_size", "64", "--width", "8", "--layers", "1", "1", "1",
        "1", "--no-bf16", "--model_type", "ModifiedResNet", "-d",
        "SketchyV1", "-e", "1", "--inference", "--seed", "3",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def sketchy(tmp_path_factory):
    return make_synthetic_sketchy(tmp_path_factory.mktemp("sketchy"),
                                  n_classes=3, photos_per_class=4,
                                  sketches_per_photo=2, size=72,
                                  with_svg=True)


def _read(folder: Path) -> dict:
    return {name: json.loads((folder / f"{name}.json").read_text())
            for name in ("training", "inference", "training_params")}


def _train(root, tmp, tag, b, *extra) -> dict:
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        out = port_train.main([*THIN, "-b", str(b), "--data_root",
                               str(root), "--results_root",
                               str(tmp / f"results_{tag}"), *extra])
    finally:
        os.chdir(cwd)
    return _read(out)


@pytest.fixture(scope="module")
def one_device(sketchy, tmp_path_factory):
    """The one-device runs at batch 4 and 5."""
    tmp = tmp_path_factory.mktemp("one")
    return {b: _train(sketchy, tmp, f"b{b}", b) for b in (4, 5)}


def _assert_jax_rule(got: dict, want: dict):
    for k in ("train_losses", "test_losses"):
        np.testing.assert_allclose(got["training"][k], want["training"][k],
                                   rtol=2e-3, err_msg=k)
    assert got["inference"]["topk_acc"] == want["inference"]["topk_acc"]
    np.testing.assert_allclose(got["inference"]["mean_reciprocal_rank"],
                               want["inference"]["mean_reciprocal_rank"],
                               rtol=1e-6)


@pytest.mark.parametrize("b", [4, 5])
def test_train_cli_two_ranks_match_one_device(sketchy, one_device, tmp_path,
                                              b):
    got = _train(sketchy, tmp_path, "dp", b, "--n_devices", "2")
    assert got["training_params"]["n_devices"] == 2
    assert one_device[b]["training_params"]["n_devices"] == 1
    _assert_jax_rule(got, one_device[b])
    # rank 0 alone wrote: one results folder, one export
    assert len(list((tmp_path / "results_dp").iterdir())) == 1
    assert len(list((tmp_path / "models").glob("*.pt"))) == 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_multihost_matches_one_device(sketchy, one_device,
                                                tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO), os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "art_sbir_tpu_torch.cli.train",
             "--multihost", *THIN, "-b", "4", "--data_root", str(sketchy),
             "--results_root", str(tmp_path / "results")],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "multihost: 2 ranks, backend gloo" in outs[0]
    (folder,) = (tmp_path / "results").iterdir()
    got = _read(folder)
    assert got["training_params"]["n_devices"] == 2
    _assert_jax_rule(got, one_device[4])


def test_train_cli_tp_exits():
    """Tensor parallelism is single-host, as JAX's: with --multihost the
    CLI exits with JAX's message (tests/test_torch_tp_cli.py runs it)."""
    with pytest.raises(SystemExit, match="single-host"):
        port_train.main(["--tp_devices", "2", "--multihost", "--device",
                         "cpu"])


def _series(folder: Path) -> dict:
    return json.loads((folder / "training.json").read_text())


def _run_in(tmp: Path, fn, argv):
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        return fn(argv)
    finally:
        os.chdir(cwd)


def _assert_series(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_pix2pix_cli_two_ranks_match_one_device(sketchy, tmp_path):
    argv = ["--mode", "train", "-e", "2", "--data_root", str(sketchy),
            "--image_size", "32", "--ngf", "8", "--ndf", "8", "-b", "4",
            "--device", "cpu"]
    runs = {}
    for n in (1, 2):
        (tmp_path / str(n)).mkdir()
        runs[n] = tmp_path / str(n) / _run_in(
            tmp_path / str(n), port_pix.main, argv + ["--n_devices", str(n)])
    one, two = (_series(runs[n])["train_losses"] for n in (1, 2))
    assert len(one["G_total"]) == 2
    _assert_series(two, one)
    assert (runs[2] / "samples.png").is_file()
    assert len(list((tmp_path / "2" / "models").glob("*.pt"))) == 1
    with pytest.raises(SystemExit, match="--mode train"):
        port_pix.main(["--n_devices", "2", "--device", "cpu"])


def test_photo2sketch_cli_two_ranks_match_one_device(sketchy, tmp_path):
    argv = ["--data_root", str(sketchy), "--size", "1.0", "--batchsize",
            "4", "--image_size", "32", "--z_size", "8", "--dec_rnn_size",
            "16", "--num_mixture", "3", "--save_rate", "1", "--max_epoch",
            "1", "--device", "cpu"]
    runs = {}
    for n in (1, 2):
        (tmp_path / str(n)).mkdir()
        out = _run_in(tmp_path / str(n), port_p2s.main,
                      argv + ["--n_devices", str(n)])
        runs[n] = _series(tmp_path / str(n) / out["folder"])
        assert (tmp_path / str(n) / out["model"]).is_file()
    for split in ("train_losses", "test_losses"):
        _assert_series(runs[2][split], runs[1][split])


# --------------------------------------------------------- compare


def _fake_run(root: Path, name: str, mrr: float) -> str:
    d = root / name
    d.mkdir(parents=True)
    (d / "inference.json").write_text(json.dumps({
        "mean_reciprocal_rank": mrr,
        "topk_acc": [min(1.0, mrr + 0.05 * k) for k in range(10)],
        "mean": 1.0 / mrr}))
    return name


def test_compare_cli_matches_jax(tmp_path, capsys):
    from art_sbir_tpu.cli import compare as jax_compare

    results = tmp_path / "results"
    a = _fake_run(results, "ModelA_SketchyV1_x", 0.5)
    b = _fake_run(results, "ModelB_SketchyV1_y", 0.25)
    mixed = results / "Mixed_run"
    mixed.mkdir()
    (mixed / "inference_updated.json").write_text(json.dumps({
        "image_features": "x",
        "drawing_stats": {"mean_reciprocal_rank": 0.9,
                          "topk_acc": [0.9] * 10, "mean": 1.1},
        "sketch_stats": {"mean_reciprocal_rank": 0.1,
                         "topk_acc": [0.1] * 10, "mean": 9.0}}))
    tables = {}
    for tag, cli in (("port", port_compare), ("jax", jax_compare)):
        cli.main([a, b, str(mixed), "--results_root", str(results),
                  "--out", str(tmp_path / f"{tag}.png")])
        out = capsys.readouterr().out.splitlines()
        assert out[-1] == f"chart written to {tmp_path / tag}.png"
        tables[tag] = out[:-1]
        assert (tmp_path / f"{tag}.png").is_file()
    assert tables["port"] == tables["jax"]
    table = "\n".join(tables["port"])
    assert "ModelA_SketchyV1_x" in table and "0.5000" in table
    assert "Mixed_run" in table and "0.9000" in table
    with pytest.raises(FileNotFoundError, match="no inference json"):
        port_compare.main([str(tmp_path)])


# ------------------------------------------------------- data_setup


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_data_setup_synthetic_matches_jax(tmp_path):
    from art_sbir_tpu.cli import data_setup as jax_setup

    for tag, cli in (("port", port_setup), ("jax", jax_setup)):
        cli.main(["--synthetic", "--root", str(tmp_path / tag)])
    port, jax_files = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(jax_files)
    assert any(k.endswith(".svg") for k in port)
    for k, v in jax_files.items():
        assert port[k] == v, k
    with pytest.raises(SystemExit):
        port_setup.main(["--learnable"])


def _all_data_info(path: Path, new_filename: bool) -> None:
    rng = np.random.default_rng(8)
    genres = ["portrait", "landscape", "abstract", "rare genre"]
    styles = ["Impressionism", "Baroque", "Cubism, late", "Rare"]
    lines = [("new_filename" if new_filename else "filename")
             + ",artist,style,genre,date"]
    for i in range(1500):
        g = genres[min(int(rng.integers(0, 40)) // 13, 3)]
        s = styles[min(int(rng.integers(0, 31)) // 10, 3)]
        if rng.random() < 0.02:
            g = ""  # a missing cell
        if rng.random() < 0.01:
            s = "NaN"
        style = f'"{s}"' if "," in s else s
        lines.append(f"{i}.jpg,artist {i % 7},{style},{g},19{i % 100:02d}")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("new_filename", [True, False])
def test_data_setup_kaggle_split_matches_jax(tmp_path, new_filename):
    from art_sbir_tpu.cli import data_setup as jax_setup

    for tag, cli in (("port", port_setup), ("jax", jax_setup)):
        kaggle = tmp_path / tag / "kaggle"
        kaggle.mkdir(parents=True)
        _all_data_info(kaggle / "all_data_info.csv", new_filename)
        cli.main(["--kaggle_split", "--root", str(tmp_path / tag)])
    for split in ("train", "test"):
        name = f"kaggle/kaggle_art_dataset_{split}.csv"
        port = (tmp_path / "port" / name).read_bytes()
        assert port == (tmp_path / "jax" / name).read_bytes(), split
        assert port.count(b"\n") > 100
    with pytest.raises(FileNotFoundError, match="all_data_info.csv"):
        port_setup.build_kaggle_split(tmp_path)


def test_data_setup_copies_the_test_images(tmp_path):
    kaggle = tmp_path / "kaggle"
    kaggle.mkdir()
    (kaggle / "kaggle_art_dataset_test.csv").write_text(
        "filename,style,genre\na.jpg,s,g\nb.jpg,s,g\n")
    src = tmp_path / "src"
    src.mkdir()
    for name in ("a.jpg", "b.jpg", "c.jpg"):
        (src / name).write_bytes(name.encode())
    port_setup.main(["--kaggle_copy_test", str(src), "--root",
                     str(tmp_path)])
    assert sorted(p.name for p in (kaggle / "photos" / "test").iterdir()) \
        == ["a.jpg", "b.jpg"]
