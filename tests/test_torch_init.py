"""The port's fresh inits against the JAX package's, tensor by tensor, on
the CPU.

The draws cannot match (torch generators against ``jax.random``'s
threefry), so each tensor is held to JAX's by its distribution: JAX's
``model.init(jax.random.key(0))`` is carried into the port's layout by
``models/port_weights.py``'s ``*_from_flax`` (so the LSTM's stored
``kernel - k`` is compared as the effective weight), and beside the
port's seeded fresh init of the same model each tensor must have

* the same family: constant, uniform, normal truncated at two of its
  stds (flax's ``lecun_normal``) or normal, told apart by their kurtosis
  (1.8, 2.37 and 3; the sample's spread is under 0.08 at 4,096
  elements) on tensors of at least 4,096 elements;
* a std within 3% of JAX's on those tensors;
* max |w| * sqrt(fan_in) <= 2 / 0.8796 + 1e-4 = 2.2737 wherever JAX's
  kernel is a truncated normal;
* the same value wherever JAX's is constant (zero biases, identity
  BatchNorm).

Widths are cut where the model has a knob (the ResNet's width and depth,
the VAE's decoder) and kept where it has none; JAX's inits are jitted,
on small inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu_torch.models import layers as PL
from art_sbir_tpu_torch.models import port_weights as PW


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for this module, restored after it: the tier-1
    suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

BOUND = 2.0 / PL.TRUNC_NORMAL_STD  # 2.2737: flax's truncation, in stds
BIG = 4096


def family(w: np.ndarray) -> str:
    w = w.astype(np.float64).ravel()
    if np.all(w == w[0]):
        return "constant"
    c = w - w.mean()
    kurtosis = np.mean(c ** 4) / np.mean(c ** 2) ** 2
    if kurtosis < 2.1:
        return "uniform"
    if kurtosis < 2.7:
        return "truncated normal"
    return "normal"


def compare(jax_sd, port_sd):
    """Every rule of the module docstring, key by key; returns the counts
    of tensors checked by family and by bound."""
    assert set(jax_sd) <= set(port_sd), sorted(set(jax_sd) - set(port_sd))
    n_family = n_bound = 0
    for key, jw in jax_sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        jw = np.asarray(jw, np.float64)
        pw = port_sd[key].detach().double().numpy()
        assert jw.shape == pw.shape, key
        if np.all(jw == jw.ravel()[0]):
            np.testing.assert_array_equal(pw, jw, err_msg=key)
            continue
        if jw.size >= BIG:
            assert family(pw) == family(jw), (key, family(pw), family(jw))
            assert abs(pw.std() / jw.std() - 1) < 0.03, (key, pw.std(),
                                                         jw.std())
            n_family += 1
        fan_in = jw[0].size if jw.ndim >= 2 else 0
        truncated = (jw.ndim >= 2 and "lstm" not in key
                     and np.abs(jw).max() * fan_in ** 0.5 <= BOUND + 1e-4)
        if truncated:
            assert np.abs(pw).max() * fan_in ** 0.5 <= BOUND + 1e-4, key
            n_bound += 1
    return n_family, n_bound


def _init(model, *args, **kw):
    """``model.init(jax.random.key(0), ...)``, jitted (an eager flax init
    compiles op by op, several times slower)."""
    init = jax.jit(model.init, static_argnames=tuple(kw))
    return init(jax.random.key(0), *args, **kw)


GEO = dict(layers=(1, 1, 1, 1), width=32, input_resolution=64,
           output_dim=256, heads=8)


@functools.lru_cache(maxsize=1)
def _jax_resnet_with_heads():
    from art_sbir_tpu.models.resnet import create_encoder as jax_encoder

    jm = jax_encoder(with_classification=True, num_classes=300,
                     dtype=jnp.float32, **GEO)
    return _init(jm, jnp.zeros((1, 64, 64, 3)), train=False)


@pytest.mark.parametrize("with_classification", [False, True])
def test_modified_resnet_init(with_classification):
    """JAX's ``ModifiedResNetWithClassification`` init once: its
    ``backbone`` subtree is the ``ModifiedResNet`` init."""
    from art_sbir_tpu_torch.models.resnet import create_encoder

    v = _jax_resnet_with_heads()
    if with_classification:
        jsd = PW.modified_resnet_with_classification_from_flax(
            v["params"], v["batch_stats"], GEO["layers"])
    else:
        jsd = PW.modified_resnet_from_flax(v["params"]["backbone"],
                                           v["batch_stats"]["backbone"],
                                           GEO["layers"])
    port = create_encoder(with_classification=with_classification,
                          num_classes=300, device="cpu",
                          compute_dtype=torch.float32, seed=0, **GEO)
    n_family, n_bound = compare(jsd, port.state_dict())
    assert n_family >= 10 and n_bound >= 20
    # the positional embedding keeps N(0, 1) / sqrt(C), untruncated
    assert family(port.attnpool.positional_embedding.detach().numpy()) == \
        "normal"


def test_photo2sketch_init():
    from art_sbir_tpu.models.photo2sketch import Photo2Sketch
    from art_sbir_tpu_torch.train.vae import VAEConfig, VAETrainer

    z, hidden, m, t = 16, 64, 3, 4
    jm = Photo2Sketch(z_size=z, dec_rnn_size=hidden, num_mixture=m,
                      max_seq_len=t)
    v = _init(jm, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, t, 5)),
              jax.random.key(1))
    jsd = PW.photo2sketch_from_flax(v["params"])
    trainer = VAETrainer(VAEConfig(z_size=z, dec_rnn_size=hidden,
                                   num_mixture=m), seed=0, device="cpu")
    n_family, n_bound = compare(jsd, trainer.model.state_dict())
    assert n_family >= 15 and n_bound >= 15
    lstm = trainer.model.Sketch_Decoder.lstm.weight_hh_l0.detach().numpy()
    assert family(lstm) == "uniform"
    assert np.abs(lstm).max() <= 1 / hidden ** 0.5


def test_drawing_and_adain_inits():
    from art_sbir_tpu.models.adain_net import AdaINDecoder, AdaINEncoder
    from art_sbir_tpu.models.drawing import DrawingGenerator
    from art_sbir_tpu_torch.cli import artwork_gen, drawings

    v = _init(DrawingGenerator(), jnp.zeros((1, 32, 32, 3)))
    gen = drawings.load_generator(None, torch.device("cpu"))
    n_family, n_bound = compare(PW.drawing_from_flax(v["params"]),
                                gen.state_dict())
    assert n_family >= 8 and n_bound >= 8
    # the transposed convs keep JAX's N(0, 0.02) (layers.py::ConvTranspose)
    assert family(gen.model3[0].weight.detach().numpy()) == "normal"

    enc_v = _init(AdaINEncoder(), jnp.zeros((1, 32, 32, 3)))
    dec_v = _init(AdaINDecoder(), jnp.zeros((1, 4, 4, 512)))
    jenc, jdec = PW.adain_from_flax(enc_v["params"], dec_v["params"])
    enc, dec = artwork_gen.load_adain(None, torch.device("cpu"))
    for jsd, port in ((jenc, enc), (jdec, dec)):
        n_family, n_bound = compare(jsd, port.state_dict())
        assert n_family >= 7 and n_bound >= 8


def test_inception_init():
    from art_sbir_tpu.models.inception import InceptionAux, InceptionV3
    from art_sbir_tpu_torch.models.inception import create_inception

    jm = InceptionV3(num_classes=10)
    v = _init(jm, jnp.zeros((1, 75, 75, 3)), train=False)
    aux = _init(InceptionAux(10), jnp.zeros((1, 17, 17, 768)), train=True)
    params = {**v["params"], "AuxLogits": aux["params"]}
    stats = {**v["batch_stats"], "AuxLogits": aux["batch_stats"]}
    jsd = PW.inception_v3_from_flax(params, stats)
    port = create_inception(num_classes=10, seed=0)
    assert set(jsd) == set(port.state_dict())
    n_family, n_bound = compare(jsd, port.state_dict())
    assert n_family >= 90 and n_bound >= 95


def test_transformer_block_init():
    from art_sbir_tpu.models.transformer import ResidualAttentionBlock
    from art_sbir_tpu_torch.models import transformer as PT

    v = _init(ResidualAttentionBlock(d_model=128, n_head=4),
              jnp.zeros((1, 5, 128)))
    jsd = PW.residual_attention_block_from_flax(v["params"])
    port = PT.init_weights(PT.ResidualAttentionBlock(128, 4), seed=0)
    n_family, n_bound = compare(jsd, port.state_dict())
    assert n_family >= 4 and n_bound >= 4


def test_flax_init_is_seeded_and_device_independent():
    """One seed, one set of weights: the generator is the CPU's, whatever
    the model's dtype or memory format (VGG is channels-last)."""
    from art_sbir_tpu_torch.models.vgg import VGGFeatures

    a = PL.flax_init(VGGFeatures(), seed=3).state_dict()
    b = PL.flax_init(VGGFeatures().to(torch.bfloat16), seed=3).state_dict()
    c = PL.flax_init(VGGFeatures(), seed=4).state_dict()
    for k in a:
        torch.testing.assert_close(b[k].float(), a[k], rtol=2 ** -8, atol=0)
    assert not torch.equal(a["0.weight"], c["0.weight"])
