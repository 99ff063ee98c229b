"""The port's offline evaluation path against the JAX package's, on the CPU.

* ``run_inference`` on the synthetic Sketchy and Kaggle corpora with the
  thin ModifiedResNet (layers (2, 1, 1, 1), width 8, 64 px, float32), one
  synthesized state dict carried into both packages: the same gallery
  paths, gallery features at rtol 1e-4 with an absolute 1e-4 (the
  encoder's float32 parity bound, ``tests/test_torch_resnet.py``), and
  the same inference dict: ranks and what comes from them exact, sample
  distances as ``tests/test_torch_rank.py`` holds them. It covers the
  two-pass Kaggle shape and the feature cache in both directions.
* ``cli/inference.py`` on a results folder with a ``.pt`` checkpoint (the
  bf16 encoder): ``inference_updated.json`` equals JAX's
  ``evaluate_retrieval`` over the port's own features, and the plots are
  written; ``--bn_recalibrate`` runs in both modes.
* ``cli/serve.py`` with ``--folder`` and no ``--features``: the engine's
  gallery is the evaluation's, path for path and row for row.
"""

import json

import numpy as np
import pytest
import torch

from art_sbir_tpu.data import get_datasets as jax_get_datasets
from art_sbir_tpu.data.synthetic import make_synthetic_kaggle as jax_kaggle
from art_sbir_tpu.data.synthetic import make_synthetic_sketchy as jax_sketchy
from art_sbir_tpu.retrieval import embed as jax_embed
from art_sbir_tpu.retrieval.engine import run_inference as jax_run_inference
from art_sbir_tpu.retrieval.rank import evaluate_retrieval as jax_evaluate
from art_sbir_tpu.train.prepare import finish_gallery_batch as jax_finish
from art_sbir_tpu_torch.cli import inference as port_cli
from art_sbir_tpu_torch.cli import serve as port_serve
from art_sbir_tpu_torch.core.checkpoint import save_state_dict
from art_sbir_tpu_torch.data import get_datasets
from art_sbir_tpu_torch.data.loader import GalleryLoader
from art_sbir_tpu_torch.models import port_weights as PW
from art_sbir_tpu_torch.models.resnet import create_encoder
from art_sbir_tpu_torch.retrieval import embed as port_embed
from art_sbir_tpu_torch.retrieval.engine import restore_encoder, run_inference
from art_sbir_tpu_torch.train.prepare import finish_gallery_batch
from tests.test_torch_rank import assert_same_inference_dict
from tests.test_torch_resnet import GEOM, LAYERS, RES, _flax, _port, _sd
from tests.torch_threads import two_torch_threads  # noqa: F401


FEATURE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def encoders():
    """(JAX forward, port forward) of one synthesized state dict."""
    sd = _sd(np.random.default_rng(0))
    model, params, stats = _flax(sd)
    variables = {"params": params, "batch_stats": stats}

    def jax_forward(x_u8):
        return model.apply(variables, jax_finish(x_u8), train=False)

    port = _port(PW.modified_resnet_from_flax(params, stats, LAYERS))

    def port_forward(x_u8):
        return port(finish_gallery_batch(x_u8))

    return jax_forward, port_forward


@pytest.fixture(scope="module")
def sketchy_root(tmp_path_factory):
    return jax_sketchy(tmp_path_factory.mktemp("sketchy"), n_classes=4,
                       photos_per_class=6, sketches_per_photo=3)


@pytest.fixture(scope="module")
def kaggle_root(tmp_path_factory):
    return jax_kaggle(tmp_path_factory.mktemp("kaggle"), n_train=8,
                      n_test=9)


def _cache(root, name, reader):
    paths, feats = reader(name, root)
    return [str(p) for p in paths], np.asarray(feats, np.float32)


def _same_cache(tmp_path, port_name, jax_name):
    """The two packages' saved galleries: equal paths, features within
    FEATURE_TOL. Returns the port's (paths, features)."""
    paths, feats = _cache(tmp_path / "port", port_name,
                          port_embed.load_image_features)
    jpaths, jfeats = _cache(tmp_path / "jax", jax_name,
                            jax_embed.load_image_features)
    assert paths == jpaths and len(paths) > 0
    np.testing.assert_allclose(feats, jfeats, **FEATURE_TOL)
    return paths, feats


def _queries(forward, catalog, resize_mode):
    loader = GalleryLoader(catalog.sketch_paths, RES, resize_mode)
    return port_embed.embed_batched(forward, loader, len(loader),
                                    device="cpu")


def _check_dict(got, want, metric, catalog, paths, feats, forward,
                resize_mode):
    """``got`` equals ``want``, and the JAX package's evaluate_retrieval
    over the features the port ranked (``feats``, and the queries that
    ``forward`` gives) gives ``got`` as well."""
    queries = _queries(forward, catalog, resize_mode)
    assert_same_inference_dict(got, want, metric, queries, feats,
                               catalog.sketch_paths, paths)
    again = jax_evaluate(queries, feats, catalog.sketch_paths, paths,
                         loss_type=metric)
    assert_same_inference_dict(got, again, metric, queries, feats,
                               catalog.sketch_paths, paths)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_run_inference_sketchy_matches_jax(tmp_path, encoders, sketchy_root,
                                           metric):
    jax_forward, port_forward = encoders
    _, test = get_datasets("SketchyV1", size=1.0, root=sketchy_root)
    _, jtest = jax_get_datasets("SketchyV1", size=1.0, root=sketchy_root)
    kw = dict(loss_type=metric, image_size=RES, model_name="Thin")
    got = run_inference(port_forward, test, feature_root=tmp_path / "port",
                        device="cpu", **kw)
    want = jax_run_inference(jax_forward, jtest,
                             feature_root=tmp_path / "jax", **kw)
    paths, feats = _same_cache(tmp_path, got["image_features"],
                               want["image_features"])
    want_cache = want.pop("image_features")
    got_cache = got.pop("image_features")
    _check_dict(got, want, metric, test, paths, feats, port_forward,
                test.resize_mode)
    assert got["size"] == len(set(test.photo_paths))

    # the feature cache round trip: the port's own cache, and the JAX
    # package's read by the port, give the same dict again
    jax_feats = _cache(tmp_path / "jax", want_cache,
                       jax_embed.load_image_features)[1]
    for root, name, cached in ((tmp_path / "port", got_cache, feats),
                               (tmp_path / "jax", want_cache, jax_feats)):
        again = run_inference(port_forward, test, feature_folder=name,
                              feature_root=root, device="cpu", **kw)
        assert again.pop("image_features") == name
        _check_dict(again, got, metric, test, paths, cached, port_forward,
                    test.resize_mode)


def test_run_inference_kaggle_two_pass_matches_jax(tmp_path, encoders,
                                                   kaggle_root):
    jax_forward, port_forward = encoders
    kw = dict(size=1.0, root=kaggle_root, img_type="images",
              sketch_type="contour_drawings")
    _, test = get_datasets("KaggleV2", **kw)
    _, jtest = jax_get_datasets("KaggleV2", **kw)
    _, kq = get_datasets("KaggleInferenceV1", sketch_type="sketches",
                         root=kaggle_root)
    _, jkq = jax_get_datasets("KaggleInferenceV1", sketch_type="sketches",
                              root=kaggle_root)
    run = dict(image_size=RES, model_name="Thin")
    got = run_inference(port_forward, test, feature_root=tmp_path / "port",
                        kaggle_queries=kq, device="cpu", **run)
    want = jax_run_inference(jax_forward, jtest,
                             feature_root=tmp_path / "jax",
                             kaggle_queries=jkq, **run)
    assert set(got) == set(want) == {"image_features", "drawing_stats",
                                     "sketch_stats"}
    paths, feats = _same_cache(tmp_path, got["image_features"],
                               want["image_features"])
    for key, catalog in (("drawing_stats", test), ("sketch_stats", kq)):
        _check_dict(got[key], want[key], "euclidean", catalog, paths, feats,
                    port_forward, test.resize_mode)
    # without the human queries a Kaggle run is single-pass
    single = run_inference(port_forward, test, save_features=False,
                           device="cpu", **run)
    assert single["image_features"] is None
    assert single["topk_acc"] == got["drawing_stats"]["topk_acc"]


def test_run_inference_trace(tmp_path, encoders, kaggle_root):
    """``trace`` on the two-pass Kaggle shape: the ranked gallery is the
    saved cache, each pass's queries are its sketches embedded, its ranks
    give its dict's MRR, and every time is positive."""
    _, port_forward = encoders
    kw = dict(size=1.0, root=kaggle_root, img_type="images",
              sketch_type="contour_drawings")
    _, test = get_datasets("KaggleV2", **kw)
    _, kq = get_datasets("KaggleInferenceV1", sketch_type="sketches",
                         root=kaggle_root)
    trace = {}
    got = run_inference(port_forward, test, feature_root=tmp_path,
                        kaggle_queries=kq, image_size=RES, model_name="Thin",
                        device="cpu", trace=trace)
    _, feats = _cache(tmp_path, got["image_features"],
                      port_embed.load_image_features)
    np.testing.assert_array_equal(trace["gallery"].numpy(), feats)
    assert trace["gallery_embed_s"] > 0 and trace["decode_s"] > 0
    assert len(trace["passes"]) == 2
    for sub, key, catalog in zip(trace["passes"],
                                 ("drawing_stats", "sketch_stats"),
                                 (test, kq)):
        np.testing.assert_array_equal(
            sub["queries"].numpy(),
            _queries(port_forward, catalog, test.resize_mode))
        assert sub["route"] == "exact"
        assert got[key]["mean_reciprocal_rank"] == float(
            np.mean(1.0 / (sub["ranks"] + 1)))
        assert sub["embed_s"] > 0 and sub["rank_s"] > 0


# ------------------------------------------------------------------ CLIs

RUN = "ModifiedResNet_SketchyV1_2026-01-01_00-00"


def _results_folder(tmp_path, sketchy_root, metric="euclidean"):
    """A run folder, with the thin tower's geometry in its training
    params, and ``models/<run>.pt`` (a seed-1 init at that geometry)."""
    run_dir = tmp_path / "results" / RUN
    run_dir.mkdir(parents=True)
    (run_dir / "data_params.json").write_text(json.dumps(
        {"dataset": "SketchyDatasetV1", "size": 1.0}))
    (run_dir / "training_params.json").write_text(json.dumps(
        {"image_size": RES, "loss_type": metric, "width": GEOM["width"],
         "layers": list(LAYERS)}))
    (run_dir / "training.json").write_text(json.dumps(
        {"train_losses": [0.9, 0.7], "test_losses": [1.0, 0.8]}))
    encoder = create_encoder(device="cpu", seed=1, input_resolution=RES,
                             width=GEOM["width"], layers=LAYERS)
    save_state_dict(tmp_path / "models" / f"{RUN}.pt", encoder.state_dict())
    return ["--folder", RUN, "--results_root", str(tmp_path / "results"),
            "--models_root", str(tmp_path / "models"), "--data_root",
            str(sketchy_root), "--feature_root", str(tmp_path / "features")]


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_inference_cli_matches_jax_evaluation(tmp_path, sketchy_root,
                                              capsys, metric):
    args = _results_folder(tmp_path, sketchy_root, metric)
    port_cli.main(args + ["--device", "cpu"])
    assert f"RUN INFERENCE AND VISUALIZATION FOR {RUN}" in \
        capsys.readouterr().out
    run_dir = tmp_path / "results" / RUN
    got = json.loads((run_dir / "inference_updated.json").read_text())
    name = got.pop("image_features")
    paths, feats = _cache(tmp_path / "features", name,
                          port_embed.load_image_features)
    # the CLI's encoder, to embed the queries as the CLI did
    model, restored = restore_encoder(
        RUN, json.loads((run_dir / "training_params.json").read_text()),
        tmp_path / "models", torch.device("cpu"))
    assert restored and model.compute_dtype == torch.bfloat16

    def forward(x):
        return model(finish_gallery_batch(x))

    _, test = get_datasets("SketchyV1", size=1.0, root=sketchy_root)
    queries = _queries(forward, test, test.resize_mode)
    want = jax_evaluate(queries, feats, test.sketch_paths, paths,
                        loss_type=metric)
    assert_same_inference_dict(got, want, metric, queries, feats,
                               test.sketch_paths, paths)
    for plot in ("topk_acc.png", "retrieval_samples.png", "losses.png"):
        assert (run_dir / plot).stat().st_size > 0, plot


def test_inference_cli_options_still_to_port(tmp_path, sketchy_root,
                                            monkeypatch, capsys):
    """BatchNorm recalibration (ported with the training slice) runs in
    both modes and writes the evaluation; ``--n_devices`` past the cards
    present exits with the mesh's message (a one-card host stood in for
    here)."""
    args = _results_folder(tmp_path, sketchy_root)
    run_dir = tmp_path / "results" / RUN
    for mode in ("mixed", "per_modality"):
        port_cli.main(args + ["--bn_recalibrate", mode, "--device", "cpu"])
        assert f"BN running stats recalibrated ({mode})" in \
            capsys.readouterr().out
        got = json.loads((run_dir / "inference_updated.json").read_text())
        assert 0 < got["mean_reciprocal_rank"] <= 1
        (run_dir / "inference_updated.json").unlink()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="wants 2 devices, only 1 present"):
        port_cli.main(["--folder", RUN, "--n_devices", "2"])


def test_inference_cli_without_data_params(tmp_path, capsys):
    (tmp_path / "results" / RUN).mkdir(parents=True)
    assert port_cli.evaluate_folder(RUN, tmp_path / "results",
                                    tmp_path / "models",
                                    device="cpu") is None
    assert f"Results {RUN} are not available" in capsys.readouterr().out


def test_serve_folder_embeds_the_evaluation_gallery(tmp_path, sketchy_root):
    args = _results_folder(tmp_path, sketchy_root)
    got = port_cli.evaluate_folder(RUN, tmp_path / "results",
                                   tmp_path / "models", sketchy_root,
                                   device="cpu",
                                   feature_root=tmp_path / "features")
    paths, feats = _cache(tmp_path / "features", got["image_features"],
                          port_embed.load_image_features)
    engine, batcher = port_serve.build_engine(port_serve.parse_args(
        args[:6] + ["--data_root", str(sketchy_root), "--device", "cpu"]))
    batcher.close()
    assert engine.image_paths == paths
    assert engine.route == "exact" and engine.n_valid == len(paths)
    np.testing.assert_array_equal(engine.gallery.numpy(), feats)
    # a search for a gallery photo finds it first
    photo = GalleryLoader(paths[:1], RES, "shortest_crop")(0, 1)
    _, idx = engine.search_arrays(photo)
    assert int(idx[0, 0]) == 0
