"""``scripts/orbax_to_pt.py`` end to end on the CPU, and the port's refusal
of an unconverted JAX run.

For each of the converter's six layouts a small JAX model is given
numpy-seeded weights (and BatchNorm statistics) and saved by the JAX
package's own ``save_pytree`` in the tree its CLI writes: the triplet
trainer's ``{params, batch_stats}`` with a ``_bn_sketch`` sibling, the
drawing generator's and Photo2Sketch's ``{params}``, AdaIN's ``{encoder,
decoder}`` and pix2pix's ``{g, d}`` (a ResNet and a U-Net generator). The
tool converts it; the port loads the result through the loader of the
CLI that takes it (``restore_encoder``, ``load_warm_start``,
``load_generator``, ``load_adain``, the pix2pix and Photo2Sketch
``load_weights``) and its forward is held to JAX's on the same inputs at
float32's reach (rtol 1e-4; each test states its atol).
"""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.core.checkpoint import save_pytree
from tests.torch_threads import two_torch_threads  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_pt", ROOT / "scripts" / "orbax_to_pt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _fill(shapes, rng):
    """Numpy values for a tree of shapes: kernels N(0, 2 / fan_in), scales
    and variances U(0.5, 1.5), the rest N(0, 0.1)."""
    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name.endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, (2 / fan_in) ** 0.5, s.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.normal(0, 0.1, s.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _variables(model, rng, *args, **kw):
    return _fill(jax.eval_shape(
        lambda: model.init(jax.random.key(0), *args, **kw)), rng)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=atol)


GEO = dict(layers=(2, 1, 1, 1), width=8, input_resolution=64)


@pytest.mark.parametrize("with_classification", [False, True])
def test_triplet_run_serves_after_conversion(tmp_path, with_classification):
    """The JAX trainer's export and its ``_bn_sketch`` sibling convert into
    ``<run>.pt`` and ``<run>_bn_sketch.pt``; ``restore_encoder`` (serve,
    inference) restores it, the warm start loads it from the run's
    directory, and both statistics sets embed as JAX's do."""
    from art_sbir_tpu.models.resnet import create_encoder as jax_encoder
    from art_sbir_tpu_torch.cli.train import load_warm_start
    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.retrieval.engine import restore_encoder

    rng = np.random.default_rng(0)
    kw = dict(with_classification=with_classification, num_classes=7)
    jm = jax_encoder(dtype=jnp.float32, **kw, **GEO)
    v = _variables(jm, rng, jnp.zeros((1, 64, 64, 3)), train=False)
    sketch_stats = _fill(jax.eval_shape(lambda: v["batch_stats"]), rng)
    kind = ("ModifiedResNet_with_classification" if with_classification
            else "ModifiedResNet")
    run = tmp_path / "models" / f"{kind}_2026-01-01"
    save_pytree(run, v)
    save_pytree(run.parent / f"{run.name}_bn_sketch",
                {"batch_stats": sketch_stats})
    written = TOOL.main(["--model_type", kind, "--src", str(run)])
    assert [p.name for p in written] == [f"{run.name}.pt",
                                         f"{run.name}_bn_sketch.pt"]

    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    params = {"model_type": kind, "num_classes": 7, "image_size": 64,
              "width": 8, "layers": [2, 1, 1, 1]}
    served, restored = restore_encoder(run.name, params, run.parent, "cpu")
    assert restored
    port = create_encoder(device="cpu", compute_dtype=torch.float32, **kw,
                          **GEO)
    load_warm_start(port, str(run))  # the directory: its .pt beside it
    for k, t in port.state_dict().items():
        assert torch.equal(served.state_dict()[k], t), k
    sketch = create_encoder(device="cpu", compute_dtype=torch.float32, **kw,
                            **GEO)
    sketch.load_state_dict(port.state_dict())
    bad = sketch.load_state_dict(
        torch.load(written[1], weights_only=True), strict=False)
    assert not bad.unexpected_keys
    apply = jax.jit(jm.apply, static_argnames="train")
    for model, stats in ((port, v["batch_stats"]), (sketch, sketch_stats)):
        want = apply({"params": v["params"], "batch_stats": stats}, x,
                     train=False)
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        for g, w in zip(got if with_classification else [got],
                        want if with_classification else [want]):
            _close(g, w, atol=1e-4 * float(np.abs(np.asarray(w)).max()))


def test_drawing_generator_converts(tmp_path):
    from art_sbir_tpu.models.drawing import DrawingGenerator
    from art_sbir_tpu_torch.cli import drawings

    rng = np.random.default_rng(1)
    jm = DrawingGenerator()
    v = _variables(jm, rng, jnp.zeros((1, 32, 32, 3)))
    save_pytree(tmp_path / "contour", {"params": v["params"]})
    (pt,) = TOOL.main(["--model_type", "DrawingGenerator", "--src",
                       str(tmp_path / "contour")])
    gen = drawings.load_generator(str(pt), torch.device("cpu"))
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    want = jax.jit(jm.apply)({"params": v["params"]}, x)
    with torch.no_grad():
        got = gen(nchw(x)).permute(0, 2, 3, 1)
    _close(got, want)


def test_adain_converts(tmp_path):
    from art_sbir_tpu.models.adain_net import AdaINDecoder, AdaINEncoder
    from art_sbir_tpu_torch.cli import artwork_gen

    rng = np.random.default_rng(2)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    feat = rng.random((2, 4, 4, 512), dtype=np.float32)
    jenc, jdec = AdaINEncoder(), AdaINDecoder()
    enc_v = _variables(jenc, rng, jnp.zeros((1, 32, 32, 3)))
    dec_v = _variables(jdec, rng, jnp.zeros((1, 4, 4, 512)))
    save_pytree(tmp_path / "adain", {"encoder": enc_v["params"],
                                     "decoder": dec_v["params"]})
    written = TOOL.main(["--model_type", "AdaIN", "--src",
                         str(tmp_path / "adain")])
    out = written[0].parent
    assert sorted(p.name for p in written) == ["decoder.pth",
                                               "vgg_normalised.pth"]
    enc, dec = artwork_gen.load_adain(str(out), torch.device("cpu"))
    with torch.no_grad():
        got_e = enc(nchw(x)).permute(0, 2, 3, 1)
        got_d = dec(nchw(feat)).permute(0, 2, 3, 1)
    want_e = jax.jit(jenc.apply)(enc_v, x)
    want_d = jax.jit(jdec.apply)(dec_v, feat)
    _close(got_e, want_e, atol=1e-4 * float(np.abs(want_e).max()))
    _close(got_d, want_d, atol=1e-4 * float(np.abs(want_d).max()))


def test_photo2sketch_converts(tmp_path):
    from art_sbir_tpu.models.photo2sketch import Photo2Sketch
    from art_sbir_tpu_torch.cli import photo2sketch
    from art_sbir_tpu_torch.train.vae import VAEConfig, VAETrainer

    z, hidden, m, t, b = 8, 16, 3, 6, 2
    rng = np.random.default_rng(3)
    jm = Photo2Sketch(z_size=z, dec_rnn_size=hidden, num_mixture=m,
                      max_seq_len=t)
    v = _variables(jm, rng, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, t, 5)),
                   jax.random.key(1))
    save_pytree(tmp_path / "p2s", {"params": v["params"]})
    (pt,) = TOOL.main(["--model_type", "Photo2Sketch", "--src",
                       str(tmp_path / "p2s")])
    trainer = VAETrainer(VAEConfig(z_size=z, dec_rnn_size=hidden,
                                   num_mixture=m), seed=1, device="cpu")
    photo2sketch.load_weights(trainer, str(pt))
    photo = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    sketch = rng.standard_normal((b, t, 5)).astype(np.float32)
    gmm_j, mu_j, _ = jax.jit(jm.apply)(v, photo, sketch, jax.random.key(1))
    eps = np.asarray(jax.random.normal(jax.random.key(1), (b, z)))
    with torch.no_grad():
        gmm_p, mu_p, _ = trainer.model(nchw(photo), torch.from_numpy(sketch),
                                       torch.from_numpy(eps))
    _close(mu_p, mu_j)
    for got, want in zip(gmm_p, gmm_j):
        _close(got, want)


@pytest.mark.parametrize("net_g", ["resnet_9blocks", "unet_256"])
def test_pix2pix_converts(tmp_path, net_g, capsys):
    """Both generators (thin: 2 residual blocks, or 5 U-Net levels at 32
    px) with a PatchGAN, batch norm; the port's ``load_weights`` fills
    both nets from the one ``.pt``. The generator's kind and norm are
    read from the tree (``--net_g`` given for the U-Net, omitted for the
    ResNet) and printed; a flag the tree contradicts is refused."""
    from art_sbir_tpu.models import pix2pix as JP
    from art_sbir_tpu_torch.cli import pix2pix
    from art_sbir_tpu_torch.models import pix2pix as PP

    rng = np.random.default_rng(4)
    if net_g == "unet_256":
        jg, pg = JP.UnetGenerator(num_downs=5, ngf=4), PP.UnetGenerator(
            num_downs=5, ngf=4)
    else:
        jg, pg = JP.ResnetGenerator(ngf=4, n_blocks=2), PP.ResnetGenerator(
            ngf=4, n_blocks=2)
    jd, pd = JP.NLayerDiscriminator(ndf=4), PP.NLayerDiscriminator(ndf=4)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    xd = rng.random((2, 32, 32, 4), dtype=np.float32)
    gv = _variables(jg, rng, jnp.zeros((1, 32, 32, 3)), train=False)
    dv = _variables(jd, rng, jnp.zeros((1, 32, 32, 4)), train=False)
    save_pytree(tmp_path / "p2p", {"g": gv, "d": dv})
    flag = ["--net_g", net_g] if net_g == "unet_256" else []
    (pt,) = TOOL.main(["--model_type", "Pix2Pix", "--src",
                       str(tmp_path / "p2p")] + flag)
    assert (f"Pix2Pix generator: --net_g {net_g} --norm batch"
            in capsys.readouterr().out)
    model = types.SimpleNamespace(net_g=pg, net_d=pd)
    pix2pix.load_weights(model, str(pt))
    with torch.no_grad():
        got_g = pg.eval()(nchw(x)).permute(0, 2, 3, 1)
        got_d = pd.eval()(nchw(xd)).permute(0, 2, 3, 1)
    apply = lambda m, v, a: jax.jit(m.apply, static_argnames="train")(
        v, a, train=False)
    _close(got_g, apply(jg, gv, x))
    want_d = apply(jd, dv, xd)
    _close(got_d, want_d, atol=1e-4 * float(np.abs(want_d).max()))
    with pytest.raises(SystemExit, match="--norm instance"):
        TOOL.main(["--model_type", "Pix2Pix", "--src", str(tmp_path / "p2p"),
                   "--net_g", net_g, "--norm", "instance"])
    other = {"unet_256": "resnet_9blocks", "resnet_9blocks": "unet_256"}
    with pytest.raises(SystemExit, match=f"--net_g {other[net_g]}"):
        TOOL.main(["--model_type", "Pix2Pix", "--src", str(tmp_path / "p2p"),
                   "--net_g", other[net_g]])


def test_an_unconverted_jax_run_is_refused(tmp_path):
    """``restore_encoder`` (serve, inference) and the warm start refuse a
    run directory without its ``.pt``, naming the converter, where they
    would have gone on from a fresh init; a missing run still serves the
    fresh init (and says so in ``serve``)."""
    from art_sbir_tpu_torch.cli.train import load_warm_start
    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.retrieval.engine import restore_encoder

    params = {"model_type": "ModifiedResNet", "image_size": 64, "width": 8,
              "layers": [2, 1, 1, 1]}
    run = tmp_path / "ModifiedResNet_2026-01-02"
    run.mkdir()
    with pytest.raises(SystemExit, match="scripts/orbax_to_pt.py"):
        restore_encoder(run.name, params, tmp_path, "cpu")
    model = create_encoder(device="cpu", **GEO)
    with pytest.raises(SystemExit, match="scripts/orbax_to_pt.py"):
        load_warm_start(model, str(run))
    _, restored = restore_encoder("absent", params, tmp_path, "cpu")
    assert not restored
