"""The port's ``cli/goldens.py`` against the JAX package's, and the port's
goldens.

* **Held against JAX.** Both packages' ``run`` and ``run_generative`` go
  through every preset with each package's CLIs and corpus makers
  replaced by stubs that record their argv and write fixed results: the
  argv equal but for the port's ``--device``, the golden dicts equal but
  for ``backend``, the card's fields and wall times, and the preset
  tables equal field for field.
* **The corpus.** ``ensure_corpus`` writes JAX's files bit for bit, its
  marker skips a second build, and another preset's corpus in the same
  root is replaced, not written over.
* **The port's CPU goldens.** ``ci`` (in bf16, and in float32 under
  ``--no-bf16``), ``gan_ci`` and ``vae_ci`` on the CPU reproduce
  ``goldens/torch_*_cpu.json``: metrics exactly, losses at
  rtol 1e-6 (``tests/test_goldens.py``'s discipline), under
  ``pin_ci_environment`` (one torch thread: bf16 sums on the CPU move
  with the thread count).
* **The card goldens' contracts**, each JAX's test of the same golden
  (``tests/test_goldens.py``) assertion for assertion, plus the card
  (``backend`` cuda, an H100 named) and the TPU golden's gallery and
  query counts.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from art_sbir_tpu.cli import goldens as jax_goldens
from art_sbir_tpu_torch.cli import goldens as port_goldens

REPO = Path(__file__).resolve().parent.parent
GOLDENS = REPO / "goldens"
ALL_PRESETS = sorted(port_goldens.PRESETS) + sorted(
    port_goldens.GENERATIVE_PRESETS)
DEVICE_FIELDS = ("backend", "device_name", "power_limit")

INFERENCE = {"size": 9, "count": 12, "mean_reciprocal_rank": 0.3125,
             "topk_acc": [0.25, 0.5, 0.5, 0.5, 0.75, 0.75, 0.75, 1.0, 1.0,
                          1.0],
             "mean": 4.5, "std": 2.5, "inference_time": 1.5}
TRAINING = {"train_losses": [2.5, 2.25], "test_losses": [1.5, 1.25],
            "epoch_metrics": [{"epoch": 1, "mrr": 0.25},
                              {"epoch": 2, "mrr": 0.3125}],
            "training_time": 3.0}
GEN_TRAINING = {
    "train_losses": {k: [1.0 + i, 0.5 + i] for i, k in enumerate(
        ("G_GAN", "G_L1", "D_real", "D_fake", "total_loss", "kl_loss",
         "reconstruction_loss"))},
    "test_losses": {"total_loss": [0.75, 0.625], "kl_loss": [0.5, 0.5]}}


@pytest.fixture
def one_thread():
    """``pin_ci_environment``, undone after the test (the worker runs
    other files next)."""
    threads = torch.get_num_threads()
    port_goldens.pin_ci_environment()
    yield
    torch.use_deterministic_algorithms(False)
    torch.set_num_threads(threads)


class Stubs:
    """Each package's CLI mains and corpus makers, recording argv and
    writing fixed results."""

    def __init__(self):
        self.argv = []
        self.corpora = []

    def train_main(self, argv):
        self.argv.append(list(argv))
        out = Path(argv[argv.index("--results_root") + 1]) / "Run"
        out.mkdir(parents=True, exist_ok=True)
        for name, payload in (("inference", INFERENCE),
                              ("training", TRAINING),
                              ("data_params",
                               {"dataset": "SketchyDatasetV2"})):
            (out / f"{name}.json").write_text(json.dumps(payload))
        return out

    def generative_main(self, argv):
        self.argv.append(list(argv))
        out = Path("results") / "Run"  # the CLIs write under the cwd
        out.mkdir(parents=True, exist_ok=True)
        (out / "training.json").write_text(json.dumps(GEN_TRAINING))

    def ensure_corpus(self, root, preset):
        self.corpora.append((str(root), dict(preset)))
        return root / "sketchy"

    def make_sketchy(self, root, **kw):
        self.corpora.append((str(root), dict(kw)))
        Path(root).mkdir(parents=True, exist_ok=True)
        return Path(root)


def _stubbed(monkeypatch, pkg: str, goldens_module) -> Stubs:
    import importlib

    stubs = Stubs()
    train = importlib.import_module(f"{pkg}.cli.train")
    p2s = importlib.import_module(f"{pkg}.cli.photo2sketch")
    pix = importlib.import_module(f"{pkg}.cli.pix2pix")
    synthetic = importlib.import_module(f"{pkg}.data.synthetic")
    monkeypatch.setattr(train, "main", stubs.train_main)
    monkeypatch.setattr(p2s, "main", stubs.generative_main)
    monkeypatch.setattr(pix, "main", stubs.generative_main)
    monkeypatch.setattr(goldens_module, "ensure_corpus", stubs.ensure_corpus)
    monkeypatch.setattr(synthetic, "make_synthetic_sketchy",
                        stubs.make_sketchy)
    return stubs


def _run(monkeypatch, pkg, module, preset, tmp, **kw):
    stubs = _stubbed(monkeypatch, pkg, module)
    if preset in module.GENERATIVE_PRESETS:
        golden = module.run_generative(preset, tmp / "work", **kw)
    else:
        golden = module.run(preset, tmp / "data", tmp / "results", seed=3,
                            **kw)
    monkeypatch.undo()
    return stubs, golden


@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_argv_and_golden_match_jax(preset, monkeypatch, tmp_path):
    jax_stubs, jax_golden = _run(monkeypatch, "art_sbir_tpu", jax_goldens,
                                 preset, tmp_path)
    port_stubs, port_golden = _run(monkeypatch, "art_sbir_tpu_torch",
                                   port_goldens, preset, tmp_path,
                                   device="cpu")
    (argv,) = port_stubs.argv
    at = argv.index("--device")
    assert argv[at + 1] == "cpu"
    assert argv[:at] + argv[at + 2:] == jax_stubs.argv[0]
    assert port_stubs.corpora == jax_stubs.corpora
    assert port_golden["backend"] == "cpu"

    def strip(g):
        return {k: v for k, v in g.items()
                if k not in DEVICE_FIELDS and k != "wall_times_s"}

    assert strip(port_golden) == strip(jax_golden)


def test_presets_match_jax():
    assert port_goldens.PRESETS == jax_goldens.PRESETS
    assert port_goldens.GENERATIVE_PRESETS == jax_goldens.GENERATIVE_PRESETS


def test_default_out_never_names_a_jax_golden(tmp_path):
    assert port_goldens.default_out("ci", "cpu") == Path(
        "goldens/torch_ci_cpu.json")
    assert port_goldens.default_out("ci", "cpu", bf16=False) == Path(
        "goldens/torch_ci_f32_cpu.json")
    with pytest.raises(SystemExit):
        port_goldens.main(["--preset", "ci", "--device", "cpu", "--out",
                           str(tmp_path / "ci_cpu.json")])
    with pytest.raises(SystemExit):  # the generative CLIs are float32
        port_goldens.main(["--preset", "vae_ci", "--no-bf16", "--device",
                           "cpu", "--out", str(tmp_path / "torch_v.json")])


def test_ensure_corpus_matches_jax_and_skips_a_second_build(tmp_path,
                                                           monkeypatch):
    preset = port_goldens.PRESETS["ci"]
    port_goldens.ensure_corpus(tmp_path / "port", preset)
    jax_goldens.ensure_corpus(tmp_path / "jax", preset)

    def files(root):
        return {p.relative_to(root): p.read_bytes()
                for p in sorted((root / "sketchy").rglob("*"))
                if p.is_file()}

    port, jax = files(tmp_path / "port"), files(tmp_path / "jax")
    assert len(port) == 1 + 12 + 24  # the marker, photos and sketches
    assert port == jax

    from art_sbir_tpu_torch.data import synthetic

    def fail(*a, **k):
        raise AssertionError("the marker should skip the build")

    monkeypatch.setattr(synthetic, "make_synthetic_sketchy", fail)
    assert port_goldens.ensure_corpus(tmp_path / "port", preset) == (
        tmp_path / "port" / "sketchy")


def test_ensure_corpus_replaces_another_presets_corpus(tmp_path):
    """A smaller preset's corpus built where a larger one lay holds only
    its own classes and files, those of a fresh build (``scale_learn``'s
    25 classes once stayed under ``learn``'s 10-class head and failed its
    classification loss on the card)."""
    big = dict(port_goldens.PRESETS["ci"], n_classes=4, photos_per_class=3)
    small = port_goldens.PRESETS["ci"]  # 3 classes x 4 photos
    port_goldens.ensure_corpus(tmp_path / "shared", big)
    port_goldens.ensure_corpus(tmp_path / "shared", small)
    port_goldens.ensure_corpus(tmp_path / "fresh", small)

    def files(root):
        return {p.relative_to(root): p.read_bytes()
                for p in sorted((root / "sketchy").rglob("*"))
                if p.is_file()}

    assert files(tmp_path / "shared") == files(tmp_path / "fresh")


def _want(name):
    want = json.loads((GOLDENS / f"torch_{name}_cpu.json").read_text())
    assert want["backend"] == "cpu"
    return want


def test_ci_preset_reproduces_golden(tmp_path, one_thread, monkeypatch):
    monkeypatch.chdir(tmp_path)  # cli/train.py exports models/<run>.pt
    want = _want("ci")
    got = port_goldens.run("ci", tmp_path / "data", tmp_path / "results",
                           seed=want["seed"], device="cpu")
    for key in ("n_gallery", "n_queries", "mrr", "topk_acc", "rank_mean",
                "rank_std", "epoch_metrics", "config", "dataset"):
        assert got[key] == want[key], key
    for key in ("final_train_loss", "final_test_loss"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key


def test_ci_f32_preset_reproduces_golden(tmp_path, one_thread, monkeypatch):
    """``--no-bf16``: the ``ci`` preset in IEEE float32 reproduces
    ``goldens/torch_ci_f32_cpu.json``, which ``chip_smoke.py``'s
    ``goldens`` phase holds the card's float32 run to."""
    monkeypatch.chdir(tmp_path)
    want = _want("ci_f32")
    assert want["precision"] == "float32"
    got = port_goldens.run("ci", tmp_path / "data", tmp_path / "results",
                           seed=want["seed"], device="cpu", bf16=False)
    for key in ("n_gallery", "n_queries", "mrr", "topk_acc", "rank_mean",
                "rank_std", "epoch_metrics", "config", "dataset",
                "precision"):
        assert got[key] == want[key], key
    for key in ("final_train_loss", "final_test_loss"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key


@pytest.mark.parametrize("preset", sorted(port_goldens.GENERATIVE_PRESETS))
def test_generative_preset_reproduces_golden(preset, tmp_path, one_thread):
    want = _want(preset)
    got = port_goldens.run_generative(preset, tmp_path / preset,
                                      device="cpu")
    assert json.loads(json.dumps(got["config"])) == want["config"]
    for split in ("train_losses", "test_losses"):
        assert sorted(got.get(split, {})) == sorted(want.get(split, {}))
        for k, series in want.get(split, {}).items():
            assert got[split][k] == pytest.approx(series, rel=1e-6), (split,
                                                                      k)


# ------------------------------------------------- the card goldens


def _card_golden(name):
    g = json.loads((GOLDENS / f"torch_{name}_cuda.json").read_text())
    assert g["backend"] == "cuda"
    assert "H100" in g["device_name"], g["device_name"]
    assert g["power_limit"].endswith("W"), g["power_limit"]
    tpu = json.loads((GOLDENS / f"{name}_tpu.json").read_text())
    assert (g["n_gallery"], g["n_queries"]) == (tpu["n_gallery"],
                                                tpu["n_queries"])
    return g


def test_scale_cuda_golden_contract():
    """``tests/test_goldens.py::test_scale_tpu_golden_contract``: the
    5,606-photo gallery and 7,500 queries with sane metrics (the corpus
    is not learnable: MRR near chance)."""
    g = _card_golden("scale")
    assert g["backend"] != "cpu"
    assert g["n_gallery"] >= 5000
    assert g["n_queries"] >= 1000
    assert 0.0 < g["mrr"] <= 1.0
    assert len(g["topk_acc"]) == 10
    assert all(0.0 <= a <= 1.0 for a in g["topk_acc"])
    assert g["topk_acc"] == sorted(g["topk_acc"])  # recall@k is monotone
    assert 1.0 <= g["rank_mean"] <= g["n_gallery"]
    assert math.isfinite(g["final_train_loss"])
    assert g["wall_times_s"]["train_embed_rank_report"] > 0


def test_learn_cuda_golden_contract():
    """``tests/test_goldens.py::test_learn_tpu_golden_contract``: the
    flagship recipe on the learnable corpus ends >= 10x above chance with
    a rising curve."""
    _learn_contract(_card_golden("learn"))


def test_learn_f32_cuda_golden_contract():
    """The same recipe in IEEE float32 on the card (``--no-bf16``, TF32
    off), recorded to tell bf16 from the rest: the same contract."""
    g = json.loads((GOLDENS / "torch_learn_f32_cuda.json").read_text())
    assert g["backend"] == "cuda" and "H100" in g["device_name"]
    assert g["power_limit"].endswith("W") and g["precision"] == "float32"
    tpu = json.loads((GOLDENS / "learn_tpu.json").read_text())
    assert (g["n_gallery"], g["n_queries"]) == (tpu["n_gallery"],
                                                tpu["n_queries"])
    assert g["config"] == tpu["config"]
    _learn_contract(g)


def _learn_contract(g):
    assert g["backend"] != "cpu"
    assert g["config"]["learnable"] is True
    chance = g["chance_mrr"]
    assert 0 < chance < 0.05
    curve = g["epoch_metrics"]
    assert len(curve) == g["config"]["epochs"]
    mrrs = [e["mrr"] for e in curve]
    assert g["mrr"] == pytest.approx(mrrs[-1], rel=1e-6)
    assert mrrs[-1] >= 10 * chance, (mrrs, chance)
    assert mrrs[-1] > mrrs[0]
    assert max(mrrs) > 2 * mrrs[0] or mrrs[0] >= 10 * chance
    top10 = [e["top10"] for e in curve]
    assert top10[-1] > top10[0]
    assert all(0 <= t <= 1 for t in top10)


def test_scale_learn_cuda_golden_contract():
    """``tests/test_goldens.py::test_scale_learn_tpu_golden_contract``:
    the learnable corpus at 224 px and a 5,606-photo gallery ends well
    above chance."""
    g = _card_golden("scale_learn")
    assert g["backend"] != "cpu"
    assert g["config"]["learnable"] is True
    assert g["n_gallery"] >= 5000
    assert g["n_queries"] >= 5000
    chance = g["chance_mrr"]
    assert 0 < chance < 0.005
    assert g["mrr"] >= 10 * chance, (g["mrr"], chance)
    curve = g["epoch_metrics"]
    assert len(curve) == g["config"]["epochs"]
    assert curve[-1]["mrr"] > 10 * chance
    assert g["topk_acc"] == sorted(g["topk_acc"])


def test_ann_learned_cuda_golden_contract():
    """``tests/test_goldens.py::test_ann_learned_tpu_golden_contract`` on
    the port's trained embeddings."""
    g = _card_golden("ann_learned")
    assert g["backend"] != "cpu"
    assert g["corpus"]["learnable"] is True
    assert g["n_gallery"] >= 50_000
    assert g["n_queries"] >= 500
    assert g["mrr"] >= 50 * g["chance_mrr"], (g["mrr"], g["chance_mrr"])
    assert g["int8_overlap"]["r40"] >= 0.97
    sweep = [g["ivf_recall"][k] for k in sorted(g["ivf_recall"], key=int)]
    assert all(b >= a - 1e-9 for a, b in zip(sweep, sweep[1:])), sweep
    tn = g["tune_nprobe"]
    assert tn["serving_choice"] >= tn["proxy_choice"], tn
    assert tn["real_recall_at_serving_choice"] >= 0.93, tn
    assert (tn["real_recall_at_serving_choice"]
            >= tn["real_recall_at_proxy_choice"] - 1e-9), tn
    pq = g["ivf_pq_recall"]
    sc = tn["serving_choice"]
    for np_ in {8, sc}:
        assert pq[f"np{np_}_r640"] >= pq[f"np{np_}_pure"] - 1e-9
    assert pq[f"np{sc}_r640"] >= pq["np8_r640"] - 1e-9, pq
    # the port's golden is written whole: the sweeps hold exactly the
    # nprobe the run measured
    assert sorted(pq) == sorted(
        [f"np{p}_{t}" for p in sorted({8, tn["proxy_choice"], sc})
         for t in ("pure", "r40", "r160", "r640")]
        + [f"opq_np{sc}_pure", f"opq_np{sc}_r640"])


def test_chance_is_the_random_ranking_expectation():
    """The golden's yardstick (ln N + gamma) / N against the exact mean of
    1 / rank over uniform ranks, H_N / N."""
    for n in (9, 735, 5606):
        exact = sum(1.0 / r for r in range(1, n + 1)) / n
        approx = port_goldens.chance_mrr(n)
        assert approx == pytest.approx(exact, rel=0.1 if n < 100 else 1e-3)
    assert np.isfinite(approx)
