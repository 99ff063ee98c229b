"""The first train step of pix2pix and of the VAE from the seed alone, the
port's against the JAX package's, on the CPU.

Neither side's weights are carried over: ``Pix2Pix(cfg, seed)`` and
``VAETrainer(cfg, seed)`` draw JAX's own init for the seed
(``models/flax_families.py``), as the JAX trainers' ``model.init``
makes it. The step's noise is the JAX package's: pix2pix without dropout,
the VAE given ``jax.random.normal(key, (B, z))``, the reparameterization
noise JAX's step draws. The losses match at the CLI tests' rule, rtol
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.train import gan as JG
from art_sbir_tpu.train import vae as JV
from art_sbir_tpu_torch.train import gan as PG
from art_sbir_tpu_torch.train import vae as PV
from tests.test_torch_pix2pix import (  # noqa: F401 (a fixture)
    CONFIGS, gan_batch, thin_defines)
from tests.torch_threads import two_torch_threads  # noqa: F401

RTOL = 1e-4


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pix2pix_first_step_from_the_seed(rng, thin_defines, name):
    """The thin nets of ``tests/test_torch_pix2pix.py`` (``ngf`` = ``ndf``
    = 8): the ResNet G with the PatchGAN (batch norm, vanilla) and the
    U-Net with the PixelGAN (instance norm, lsgan), seed 3."""
    size = 32 if name == "resnet_basic" else 64
    kw = dict(image_size=size, ngf=8, ndf=8, use_dropout=False,
              **CONFIGS[name])
    jm = JG.Pix2Pix(JG.Pix2PixConfig(**kw), jax.random.key(3))
    pm = PG.Pix2Pix(PG.Pix2PixConfig(**kw), seed=3, device="cpu")
    jb, pb = gan_batch(rng, size)
    want = jm.train_step(jb, jax.random.key(1))
    got = pm.train_step(pb, 1)
    assert set(got) == set(want) == set(PG.LOSS_KEYS)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=RTOL), k


def test_vae_first_step_from_the_seed():
    """``z`` 8, decoder width 16, 3 mixtures, 10 strokes, 64 px, seed 3."""
    cfg = dict(z_size=8, dec_rnn_size=16, num_mixture=3, max_seq_len=10,
               image_size=64)
    b = 2
    rng = np.random.default_rng(5)
    batch = {"photo": rng.standard_normal((b, 64, 64, 3)).astype(np.float32),
             "sketch_vector": rng.standard_normal((b, 10, 5)).astype(
                 np.float32)}
    jt = JV.VAETrainer(JV.VAEConfig(**cfg), jax.random.key(3))
    want = jt.train_step({k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.key(1))
    eps = np.asarray(jax.random.normal(jax.random.key(1), (b, 8)))
    pt = PV.VAETrainer(PV.VAEConfig(**cfg), seed=3, device="cpu")
    got = pt.train_step({"photo": torch.from_numpy(np.ascontiguousarray(
        batch["photo"].transpose(0, 3, 1, 2))),
        "sketch_vector": torch.from_numpy(batch["sketch_vector"])},
        torch.from_numpy(eps))
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=RTOL), k
