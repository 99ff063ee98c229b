"""The port's training CLI against the JAX package's, on the CPU
(the loader, the learnable corpus and BatchNorm recalibration are in
``tests/test_torch_train_data.py``).

* ``cli/train.py`` in both packages from one init (JAX's ``-m`` from
  ``save_pytree``, the port's from the carried ``.pt``), ``--no-bf16``,
  the thin encoder (layers (1, 1, 1, 1), width 8, 64 px), two epochs of
  synthetic SketchyV1 at learning rate 0: per-epoch train and test losses
  within rtol 1e-4 (absolute 1e-5: a margin loss keeps its distances'
  absolute error), the same training-dict keys, and the same inference
  dict (ranks and what comes from them exact; sample distances at rtol
  1e-4, the encoder's parity bound). The learning rate is 0 because
  Adam's first step moves every parameter by about lr * sign(g): where
  an element's gradient lies within float32 noise the two packages move
  it by opposite steps, and at lr 1e-5 the losses part by about 1e-4
  within a few steps. With lr 0 the runs still take every step (the
  loader, the finishing, three train-mode forwards, the loss, backward,
  the optimizer call and the running statistics' updates, which the test
  losses read); the update itself is held by ``tests/test_torch_train.py``
  (Adam from the same gradients, and ``TripletTrainer.run``).
* flax's ``BatchNorm`` takes the variance in one pass, E[x^2] - E[x]^2,
  which on the near-white sketches cancels: JAX's first-step loss there
  lies 2e-4 from a float64 reference where the port's (two passes) lies
  1.5e-5 from it. These tests run the JAX package with flax's two-pass
  variance (``use_fast_variance=False``), the estimator the port uses.
  Its float32 reductions still carry more error than the port's: the
  first sketch batch's mean after ``conv1`` (4,096 values a channel) lies
  3.3e-5 from a float64 recomputation in JAX and within 1e-7 of it in the
  port. So losses, which read the running statistics, and statistics are
  held at rtol 1e-4, not 1e-5.
* Resume as ``tests/test_resume.py`` holds JAX's, with ``<epoch>.pt``
  checkpoints; the options still to port exit naming their ROADMAP item;
  a warm start drops a classifier head of another size.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.cli import train as jax_cli
from art_sbir_tpu.core.checkpoint import save_pytree
from art_sbir_tpu.data.synthetic import make_synthetic_sketchy as jax_sketchy
from art_sbir_tpu.models.resnet import create_encoder as jax_encoder
from art_sbir_tpu_torch.cli import train as port_cli
from art_sbir_tpu_torch.core.checkpoint import save_state_dict
from art_sbir_tpu_torch.models import port_weights as PW
from art_sbir_tpu_torch.models.resnet import create_encoder
from tests.torch_threads import two_torch_threads  # noqa: F401


LAYERS, WIDTH, RES = (1, 1, 1, 1), 8, 64
THIN = ["--image_size", str(RES), "--width", str(WIDTH), "--layers",
        *map(str, LAYERS)]
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
# a running mean near 0 keeps the absolute error of its sum of O(1) values
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
RANK_KEYS = ("mean_reciprocal_rank", "size", "count", "mean", "std", "min",
             "25%", "50%", "75%", "max", "topk_acc")


@pytest.fixture(scope="module")
def sketchy_root(tmp_path_factory):
    return jax_sketchy(tmp_path_factory.mktemp("sketchy"), n_classes=3,
                       photos_per_class=4, sketches_per_photo=2, size=72)


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """One float32 flax init of the thin ModifiedResNet: (params, stats,
    JAX checkpoint dir, port .pt)."""
    d = tmp_path_factory.mktemp("init")
    model = jax_encoder(with_classification=False, dtype=jnp.float32,
                        input_resolution=RES, width=WIDTH, layers=LAYERS)
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.key(3), jnp.zeros((1, RES, RES, 3)), train=False)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params, stats = to_np(v["params"]), to_np(v["batch_stats"])
    save_pytree(d / "jax_init", {"params": params, "batch_stats": stats})
    save_state_dict(d / "port_init.pt",
                    PW.modified_resnet_from_flax(params, stats, LAYERS))
    return model, params, stats, d / "jax_init", d / "port_init.pt"


@pytest.fixture(scope="module", autouse=True)
def two_pass_variance():
    """flax's BatchNorm statistics with the two-pass variance (see the
    module docstring); the JAX package itself is left as it is."""
    import flax.linen.normalization as fnorm

    orig = fnorm._compute_stats

    def two_pass(*args, **kw):
        kw["use_fast_variance"] = False
        return orig(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnorm, "_compute_stats", two_pass)
        yield


def _cli_args(root, tmp, model_path):
    return ["-e", "2", "-b", "3", "-l", "0", "-d", "SketchyV1",
            "--model_type", "ModifiedResNet", "--data_root", str(root), "-m",
            str(model_path), "--no-bf16", "--inference", "--results_root",
            str(tmp / "results"), *THIN]


@pytest.fixture(scope="module")
def cli_runs(sketchy_root, init, two_pass_variance, tmp_path_factory):
    """The two CLIs' result folders, each run from its own directory."""
    import os

    out = {}
    cwd = os.getcwd()
    try:
        for name, main, model_path in (("jax", jax_cli.main, init[3]),
                                       ("port", port_cli.main, init[4])):
            tmp = tmp_path_factory.mktemp(name)
            os.chdir(tmp)
            args = _cli_args(sketchy_root, tmp, model_path)
            out[name] = (main(args + (["--device", "cpu"]
                                      if name == "port" else [])), tmp)
    finally:
        os.chdir(cwd)
    return out


def _read(folder, name):
    return json.loads((folder / f"{name}.json").read_text())


def test_train_cli_matches_jax(cli_runs):
    (jdir, _), (pdir, ptmp) = cli_runs["jax"], cli_runs["port"]
    want, got = _read(jdir, "training"), _read(pdir, "training")
    assert set(got) == set(want)
    assert got["steps"] == want["steps"] > 0
    for k in ("train_losses", "test_losses"):
        assert len(got[k]) == 2
        np.testing.assert_allclose(got[k], want[k], **LOSS_TOL, err_msg=k)
    assert got["mean_step_time"] > 0
    assert _read(pdir, "data_params") == _read(jdir, "data_params")
    jp, pp = _read(jdir, "training_params"), _read(pdir, "training_params")
    assert set(pp) == set(jp)
    assert {k: v for k, v in pp.items() if k != "model"} == {
        k: v for k, v in jp.items() if k != "model"}
    wi, gi = _read(jdir, "inference"), _read(pdir, "inference")
    assert set(gi) == set(wi)
    for k in RANK_KEYS:
        assert gi[k] == wi[k], k
    for gs, ws in zip(gi["retrieval_samples"], wi["retrieval_samples"]):
        (gk, gv), = gs.items()
        (wk, wv), = ws.items()
        assert gk == wk and [p for p, _ in gv] == [p for p, _ in wv]
        np.testing.assert_allclose([x for _, x in gv], [x for _, x in wv],
                                   rtol=1e-4)
    assert (ptmp / "models" / f"{pdir.name}.pt").is_file()
    assert (pdir / "losses.png").stat().st_size > 0


def test_train_cli_resumes(sketchy_root, init, tmp_path, monkeypatch):
    """``tests/test_resume.py``'s recipe: one epoch with a checkpoint
    directory (and a profiler trace), then ``-e 2 --resume`` trains
    exactly one more epoch."""
    monkeypatch.chdir(tmp_path)
    common = ["-b", "4", "-d", "SketchyV1", "--model_type", "ModifiedResNet",
              "--data_root", str(sketchy_root), "--results_root",
              str(tmp_path / "results"), "--checkpoint_dir",
              str(tmp_path / "ckpt"), "--device", "cpu", *THIN]
    t1 = _read(port_cli.main(["-e", "1", "--trace_dir",
                              str(tmp_path / "trace")] + common), "training")
    assert t1["steps"] > 0 and t1["mean_step_time"] > 0
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert (tmp_path / "ckpt" / "1.pt").is_file()
    ckpt = torch.load(tmp_path / "ckpt" / "1.pt", weights_only=True)
    assert ckpt["step"] == t1["steps"] and ckpt["optimizer"]["state"]
    t2 = _read(port_cli.main(["-e", "2", "--resume"] + common), "training")
    assert len(t2["train_losses"]) == 1  # epochs 1..2 from start_epoch 1
    assert np.isfinite(t2["train_losses"][0])
    assert torch.load(tmp_path / "ckpt" / "2.pt",
                      weights_only=True)["step"] == 2 * t1["steps"]


@pytest.mark.parametrize("flags", [["--tp_devices", "2", "--multihost"]])
def test_train_cli_parallel_options_exit(flags):
    """--tp_devices runs (tests/test_torch_tp_cli.py) but, as JAX's, on
    one host only."""
    with pytest.raises(SystemExit, match="single-host"):
        port_cli.main(flags + ["--device", "cpu"])


def test_train_cli_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli.main([])


def test_warm_start_drops_a_resized_head(init, tmp_path):
    """A reference-layout state dict with a classifier of another size:
    the backbone loads, the head keeps its fresh init."""
    _, params, stats, _, _ = init
    sd = PW.modified_resnet_from_flax(params, stats, LAYERS)
    sd["classifier.weight"] = torch.ones(7, 1024)
    sd["classifier.bias"] = torch.ones(7)
    save_state_dict(tmp_path / "ref.pth", sd)
    model = create_encoder(with_classification=True, num_classes=5,
                           device="cpu", input_resolution=RES, width=WIDTH,
                           layers=LAYERS)
    head = model.classifier.weight.detach().clone()
    port_cli.load_warm_start(model, str(tmp_path / "ref.pth"))
    assert torch.equal(model.classifier.weight, head)
    assert torch.equal(model.conv1.weight, sd["conv1.weight"])
