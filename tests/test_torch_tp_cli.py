"""The port's tensor-parallel ``cli/train.py`` on the CPU against one
process, its checkpoints across layouts, and ``mesh_from_args`` against
JAX's.

* ``cli/train.py --tp_devices 2 --no-bf16 --device cpu`` (a 1 x 2 grid of
  gloo ranks) against one process on a synthetic SketchyV1 corpus at 64 px
  with the thin encoder and ``--inference``, by JAX's tensor-parallel CLI
  rule (``tests/test_sharding.py:353-396``): train losses at rtol 1e-4,
  test losses at 1e-3, the last ``topk_acc`` equal, MRR at rtol 0.2;
  ``training_params.json`` records ``n_devices`` 2 and ``tp_devices`` 2.
  The runs are at ``-l 0``, as the repo's other CLI parity runs, and the
  one process at one intra-op thread, as each rank: one process alone
  moves its train loss by 8e-5 between one and two threads at lr 0 here
  (1.7e-4 at lr 1e-5, where Adam's sign-like first steps turn float32
  noise into lr-sized moves); every step, BatchNorm's statistics, the
  collectives and Adam still run.
* Its checkpoint (``--checkpoint_dir``) is in one device's layout: one
  process resumes it (``--resume``) and its train state holds it bit for
  bit; the two ranks then resume the one process's checkpoint and hold
  it bit for bit too, each rank its slices.
* ``mesh_from_args`` follows JAX's (``tests/test_sharding.py:494-510``),
  on the CPU and on eight cards (``cuda_devices`` stubbed).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from art_sbir_tpu_torch.cli import train as port_train
from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy
from art_sbir_tpu_torch.parallel import mesh as M
from art_sbir_tpu_torch.parallel import multihost as MH
from art_sbir_tpu_torch.parallel import tensor as T
from art_sbir_tpu_torch.train import triplet as PT
from tests.test_torch_parallel import RankPool
from tests.torch_threads import two_torch_threads  # noqa: F401

THIN = ["--image_size", "64", "--width", "8", "--layers", "1", "1", "1",
        "1", "--no-bf16", "--model_type", "ModifiedResNet", "-d",
        "SketchyV1", "--inference", "--seed", "3", "-b", "4", "-l", "0",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def sketchy(tmp_path_factory):
    return make_synthetic_sketchy(tmp_path_factory.mktemp("sketchy"),
                                  n_classes=3, photos_per_class=4,
                                  sketches_per_photo=2, size=72)


def _in(tmp: Path, fn, argv, threads: int = 2):
    """``fn(argv)`` from ``tmp`` (made here) at ``threads`` intra-op
    threads."""
    cwd, n = os.getcwd(), torch.get_num_threads()
    tmp.mkdir()
    os.chdir(tmp)
    torch.set_num_threads(threads)
    try:
        return tmp / fn(argv)
    finally:
        os.chdir(cwd)
        torch.set_num_threads(n)


def _read(folder: Path) -> dict:
    return {name: json.loads((folder / f"{name}.json").read_text())
            for name in ("training", "inference", "training_params")}


# ----------------------------------------------------------- cli/train


def _encoder_state(device, ckpt: dict) -> dict:
    """This rank's train state after loading ``ckpt`` (one device's
    layout): its slices, and the state it gives back, gathered."""
    from art_sbir_tpu_torch.models.resnet import create_encoder

    if MH.is_parallel():
        MH.init_grid(2)
    model = create_encoder(compute_dtype=torch.float32, device="cpu",
                           seed=3, input_resolution=64, width=8,
                           layers=(1, 1, 1, 1))
    T.tensor_parallel(model, T.model_shard())
    state = PT.create_train_state(model)
    state.load_state_dict(ckpt)
    return {"slices": {k: v.clone() for k, v in model.state_dict().items()},
            "state": state.state_dict()}


def _equal(a, b) -> bool:
    """Nested dicts and lists of tensors and plain values, bit for bit."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_train_cli_tp_matches_one_process_and_resumes(sketchy, tmp_path):
    ck = tmp_path / "ckpt"
    # one thread, as each of the two ranks runs (spawn splits the two)
    one = _read(_in(tmp_path / "one", port_train.main, THIN + [
        "-e", "1", "--data_root", str(sketchy)], threads=1))
    tp = _read(_in(tmp_path / "tp", port_train.main, THIN + [
        "-e", "1", "--tp_devices", "2", "--data_root", str(sketchy),
        "--checkpoint_dir", str(ck)]))
    assert (tp["training_params"]["n_devices"],
            tp["training_params"]["tp_devices"]) == (2, 2)
    np.testing.assert_allclose(tp["training"]["train_losses"],
                               one["training"]["train_losses"], rtol=1e-4)
    np.testing.assert_allclose(tp["training"]["test_losses"],
                               one["training"]["test_losses"], rtol=1e-3)
    assert tp["inference"]["topk_acc"][-1] == one["inference"]["topk_acc"][-1]
    np.testing.assert_allclose(tp["inference"]["mean_reciprocal_rank"],
                               one["inference"]["mean_reciprocal_rank"],
                               rtol=0.2)
    # the export and the checkpoint are in one device's layout
    (export,) = (tmp_path / "tp" / "models").glob("*.pt")
    ckpt = torch.load(ck / "1.pt", weights_only=True)
    whole = _encoder_state("cpu", ckpt)
    assert _equal(whole["state"], ckpt)
    assert {k: v.shape for k, v in torch.load(
        export, weights_only=True).items()} == {
        k: v.shape for k, v in whole["slices"].items()}

    # one process resumes the two ranks' checkpoint, the ranks its
    resumed = _read(_in(tmp_path / "resume", port_train.main, THIN + [
        "-e", "2", "--resume", "--checkpoint_dir", str(ck), "--data_root",
        str(sketchy)]))
    assert len(resumed["training"]["train_losses"]) == 1  # epoch 2 only
    ckpt2 = torch.load(ck / "2.pt", weights_only=True)
    assert ckpt2["step"] == 2 * ckpt["step"]
    pool = RankPool(2)
    try:
        parts = pool.run(_encoder_state, "cpu", ckpt2)
    finally:
        pool.close()
    for m, part in enumerate(parts):
        assert _equal(part["state"], ckpt2)
        lay = T.tp_dims(whole_model(), 2)
        for k, v in part["slices"].items():
            want = ckpt2["model"][k]
            if k in lay:
                want = want.chunk(2, lay[k])[m]
            assert torch.equal(v, want), (m, k)


def whole_model():
    from art_sbir_tpu_torch.models.resnet import create_encoder

    return create_encoder(compute_dtype=torch.float32, device="cpu", seed=3,
                          input_resolution=64, width=8, layers=(1, 1, 1, 1))


# ---------------------------------------------------------- the mesh


def test_mesh_from_args_follows_jax(monkeypatch):
    from art_sbir_tpu.parallel import mesh as jax_mesh

    cpu = torch.device("cpu")
    assert M.mesh_from_args(1, device="cpu") is None
    assert M.mesh_from_args(0, device="cpu") is None
    mesh = M.mesh_from_args(2, 4, device="cpu")
    want, tp = jax_mesh.mesh_from_args(2, 4)
    assert tp and (mesh.n_data, mesh.n_model) == tuple(want.shape.values()) \
        == (2, 4)
    assert mesh.devices == (cpu,) * 8 and mesh.data_devices() == [cpu]
    mesh = M.mesh_from_args(-1, 2, device="cpu")
    assert (mesh.n_data, mesh.n_model) == (1, 2)
    with pytest.raises(SystemExit, match="single-host"):
        M.mesh_from_args(2, 4, device="cpu", multihost=True)
    with pytest.raises(SystemExit, match="single-host"):
        jax_mesh.mesh_from_args(2, 4, multihost=True)

    # eight cards, as JAX's eight devices: -1 is every card over tp
    cards = [torch.device("cuda", i) for i in range(8)]
    monkeypatch.setattr(M, "cuda_devices", lambda: cards)
    monkeypatch.setattr(M, "resolve_device", lambda d=None: torch.device(
        "cuda"))
    mesh = M.mesh_from_args(-1, 4, device="cuda")
    want, _ = jax_mesh.mesh_from_args(-1, 4)
    assert (mesh.n_data, mesh.n_model) == tuple(want.shape.values()) == (2,
                                                                         4)
    assert mesh.devices == tuple(cards)
    assert mesh.data_devices() == [cards[0], cards[4]]
    with pytest.raises(SystemExit, match=r"mesh_2d wants 3x4=12 devices, "
                                         r"only 8 present"):
        M.mesh_from_args(3, 4, device="cuda")
