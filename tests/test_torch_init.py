"""The port's fresh inits are the JAX package's, tensor by tensor, on the
CPU.

JAX's ``model.init`` (jitted: an eager flax init compiles op by op,
several times slower) under the keys the JAX CLIs use is carried into the
port's layout by ``models/port_weights.py``'s ``*_from_flax`` (so the
LSTM's stored ``kernel - k`` is compared as the effective weight) and
held to the port's seeded init by ``tests/test_torch_jax_init.py``'s
rule: the key sets equal, constants (biases, identity BatchNorm, its
statistics) exactly, every drawn value within ``flax_draw.DRAW_ULP``
float32 ulp (the inverse error function's rounding) and under 3% of them
differing at all. Each family at thin widths where it has a knob, for two
seeds:

* the triplet encoder (``models/flax_draw.py``), with and without heads;
* the VAE through ``VAETrainer(cfg, seed)`` (``key(seed)``, JAX
  ``train/vae.py:91``);
* the drawing generator and AdaIN (``key(0)``, and ``key(0)`` and
  ``key(1)``, through the CLIs' loaders) and other keys;
  ``GlobalGenerator2``;
* the CLIP block through ``transformer.init_weights``.

pix2pix is held in ``tests/test_torch_pix2pix_init.py``; InceptionV3, and
each family at full width against a committed digest of JAX's seed-0
init, in ``tests/test_torch_jax_init_families.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu_torch.models import flax_families as FF
from art_sbir_tpu_torch.models import port_weights as PW
from tests.test_torch_jax_init import compare
from tests.torch_threads import two_torch_threads  # noqa: F401

SEEDS = [0, 1]


@functools.lru_cache(maxsize=None)
def _jit_init(model, **static):
    """A jitted ``model.init`` for one model (flax modules hash by their
    fields): compiled once, called for each key."""
    return jax.jit(functools.partial(model.init, **static))


def _init(model, key, *args, **static):
    return _jit_init(model, **static)(key, *args)


def _held(want: dict, have: dict) -> None:
    got = compare(want, have)
    assert got["share"] < 0.03, got


GEO = dict(layers=(1, 1, 1, 1), width=32, input_resolution=64,
           output_dim=256, heads=8)


@functools.lru_cache(maxsize=1)
def _jax_resnet_with_heads():
    from art_sbir_tpu.models.resnet import create_encoder as jax_encoder

    jm = jax_encoder(with_classification=True, num_classes=300,
                     dtype=jnp.float32, **GEO)
    return _init(jm, jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                 train=False)


@pytest.mark.parametrize("with_classification", [False, True])
def test_modified_resnet_init(with_classification):
    """JAX's ``ModifiedResNetWithClassification`` init once: the port's
    encoder with its heads is that init, and the port's bare
    ``ModifiedResNet`` is JAX's bare init (its own key paths, without
    ``backbone``), tensor by tensor."""
    from art_sbir_tpu.models.resnet import create_encoder as jax_encoder
    from art_sbir_tpu_torch.core import jax_random
    from art_sbir_tpu_torch.models import flax_draw
    from art_sbir_tpu_torch.models.resnet import create_encoder

    if with_classification:
        v = _jax_resnet_with_heads()
        jsd = PW.modified_resnet_with_classification_from_flax(
            v["params"], v["batch_stats"], GEO["layers"])
    else:
        v = _init(jax_encoder(dtype=jnp.float32, **GEO), jax.random.key(0),
                  jnp.zeros((1, 64, 64, 3)), train=False)
        jsd = PW.modified_resnet_from_flax(v["params"], v["batch_stats"],
                                           GEO["layers"])
    port = create_encoder(with_classification=with_classification,
                          num_classes=300, device="cpu",
                          compute_dtype=torch.float32, seed=0,
                          **GEO).state_dict()
    assert sorted(jsd) == sorted(port)
    drawn = 0
    for key, jw in jsd.items():
        jw = np.asarray(jw)
        pw = port[key].detach().numpy()
        assert jw.shape == pw.shape, key
        if (not np.issubdtype(jw.dtype, np.floating)
                or np.all(jw == jw.flat[0])):
            np.testing.assert_array_equal(pw, jw, err_msg=key)
            continue
        ulps = jax_random.ulp_distance(pw, jw)
        assert ulps.max() <= flax_draw.DRAW_ULP, (key, int(ulps.max()))
        drawn += 1
    assert drawn >= 20
    # the positional embedding keeps N(0, 1) / sqrt(C), untruncated
    pos = port["attnpool.positional_embedding"].numpy().astype(np.float64)
    c = pos.ravel() - pos.mean()
    assert np.mean(c ** 4) / np.mean(c ** 2) ** 2 >= 2.7  # a normal's 3


@pytest.mark.parametrize("seed", SEEDS)
def test_photo2sketch_init(seed):
    """``VAETrainer(cfg, seed)`` against ``Photo2Sketch.init(key(seed))``
    (the decoder's leaves made inside its ``nn.scan``, the LSTM's four in
    one scope)."""
    from art_sbir_tpu.models.photo2sketch import Photo2Sketch
    from art_sbir_tpu_torch.train.vae import VAEConfig, VAETrainer

    z, hidden, m, t = 16, 64, 3, 4
    v = _init(Photo2Sketch(z_size=z, dec_rnn_size=hidden, num_mixture=m,
                           max_seq_len=t), jax.random.key(seed),
              jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, t, 5)),
              jax.random.key(0))
    trainer = VAETrainer(VAEConfig(z_size=z, dec_rnn_size=hidden,
                                   num_mixture=m), seed=seed, device="cpu")
    _held(PW.photo2sketch_from_flax(v["params"]),
          trainer.model.state_dict())


# ------------------------------------------------ the drawing generators


@pytest.mark.parametrize("seed", SEEDS)
def test_drawing_and_adain_inits(seed):
    """``DrawingGenerator`` under ``key(seed)``, AdaIN's encoder under
    ``key(seed)`` and its decoder under ``key(seed + 1)``; seed 0 through
    the CLIs' loaders (``--model`` omitted), whose keys those are."""
    from art_sbir_tpu.models.adain_net import AdaINDecoder, AdaINEncoder
    from art_sbir_tpu.models.drawing import DrawingGenerator
    from art_sbir_tpu_torch.cli import artwork_gen, drawings

    cpu = torch.device("cpu")
    v = _init(DrawingGenerator(), jax.random.key(seed),
              jnp.zeros((1, 32, 32, 3)))
    gen = (drawings.load_generator(None, cpu).state_dict() if seed == 0
           else FF.drawing_generator(seed))
    _held(PW.drawing_from_flax(v["params"]), gen)

    enc_v = _init(AdaINEncoder(), jax.random.key(seed),
                  jnp.zeros((1, 32, 32, 3)))
    dec_v = _init(AdaINDecoder(), jax.random.key(seed + 1),
                  jnp.zeros((1, 4, 4, 512)))
    if seed == 0:
        port = tuple(m.state_dict()
                     for m in artwork_gen.load_adain(None, cpu))
    else:
        port = FF.adain(seed, seed + 1)
    for want, have in zip(PW.adain_from_flax(enc_v["params"],
                                             dec_v["params"]), port):
        _held(want, have)


@pytest.mark.parametrize("seed", SEEDS)
def test_global_generator2_init(seed):
    """``GlobalGenerator2`` at ``ngf`` 4 with 2 blocks: its auto-named
    convs, transposed convs and BatchNorms; the draw loads into the
    port's model."""
    from art_sbir_tpu.models.drawing import GlobalGenerator2
    from art_sbir_tpu_torch.models import drawing as PD

    geo = dict(ngf=4, n_blocks=2)
    v = _init(GlobalGenerator2(**geo), jax.random.key(seed),
              jnp.zeros((1, 5, 5, 3)), train=False)
    have = FF.global_generator2(seed, **geo)
    PD.GlobalGenerator2(**geo).load_state_dict(have)
    _held(PW.global_generator2_from_flax(v["params"], v["batch_stats"],
                                         **geo), have)


# -------------------------------------------------------- the CLIP block


@pytest.mark.parametrize("seed", SEEDS)
def test_transformer_block_init(seed):
    """``init_weights`` against ``ResidualAttentionBlock.init(key(seed))``
    at width 128 with 4 heads (q, k, v and out drawn flat)."""
    from art_sbir_tpu.models.transformer import ResidualAttentionBlock
    from art_sbir_tpu_torch.models import transformer as PT

    v = _init(ResidualAttentionBlock(d_model=128, n_head=4),
              jax.random.key(seed), jnp.zeros((1, 5, 128)))
    port = PT.init_weights(PT.ResidualAttentionBlock(128, 4), seed=seed)
    _held(PW.residual_attention_block_from_flax(v["params"]),
          port.state_dict())


def test_jax_draw_is_seeded_and_device_independent():
    """One seed, one set of weights: the draw runs on the host, whatever
    the model's dtype or memory format (the VAE's VGG is channels-last,
    and stays so), and seeds differ."""
    from art_sbir_tpu_torch.models.photo2sketch import Photo2Sketch

    a = FF.photo2sketch(3, 8, 16, 2)
    model = Photo2Sketch(8, 16, 2).to(torch.bfloat16)
    model.load_state_dict(a)
    conv = model.Image_Encoder.feature[0].weight
    assert conv.is_contiguous(memory_format=torch.channels_last)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, a[k].to(v.dtype), rtol=0, atol=0)
    FF.photo2sketch.cache_clear()
    b = FF.photo2sketch(3, 8, 16, 2)
    c = FF.photo2sketch(4, 8, 16, 2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "Image_Encoder.feature.0.weight"
    assert not torch.equal(a[w], c[w])
