"""The port's pix2pix init is the JAX package's, tensor by tensor, on the
CPU: ``Pix2Pix(cfg, seed)``'s G and D against JAX's ``define_g`` and
``define_d`` inits under ``split(key(seed))`` (G from the first key, D
from the second, JAX ``train/gan.py:79-81``), jitted as the JAX trainer
runs them, by ``tests/test_torch_jax_init.py``'s rule (constants exact,
drawn values within ``flax_draw.DRAW_ULP`` float32 ulp, under 3% of them
differing), at ``ngf`` = ``ndf`` = 4, for two seeds.

Every ``--netG`` meets every ``--norm`` (the norm decides the conv
biases and the BatchNorm leaves), and every ``--netD`` two of them. The
U-Net's 8 downs take a 256 px input, its smallest.
"""

import jax
import jax.numpy as jnp
import pytest

from art_sbir_tpu_torch.models import port_weights as PW
from tests.test_torch_init import _held, _init
from tests.torch_threads import two_torch_threads  # noqa: F401

PIX2PIX = [("resnet_9blocks", "basic", "batch"),
           ("unet_256", "n_layers", "batch"),
           ("resnet_9blocks", "pixel", "instance"),
           ("unet_256", "basic", "instance"),
           ("resnet_9blocks", "n_layers", "none"),
           ("unet_256", "pixel", "none")]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("net_g,net_d,norm", PIX2PIX,
                         ids=["-".join(c) for c in PIX2PIX])
def test_pix2pix_init(net_g, net_d, norm, seed):
    from art_sbir_tpu.models import pix2pix as JP
    from art_sbir_tpu_torch.train.gan import Pix2Pix, Pix2PixConfig

    size = 256 if net_g == "unet_256" else 32
    cfg = Pix2PixConfig(net_g=net_g, net_d=net_d, norm=norm, ngf=4, ndf=4,
                        n_layers_d=2, image_size=size)
    port = Pix2Pix(cfg, seed, device="cpu")
    kg, kd = jax.random.split(jax.random.key(seed))
    g = _init(JP.define_g(net_g, 1, 4, norm), kg,
              jnp.zeros((1, size, size, 3)), train=False)
    d = _init(JP.define_d(net_d, 4, 2, norm), kd,
              jnp.zeros((1, size, size, 4)), train=False)
    _held(PW.pix2pix_g_from_flax(net_g, g["params"],
                                 g.get("batch_stats", {})),
          port.net_g.state_dict())
    _held(PW.pix2pix_d_from_flax(net_d, d["params"],
                                 d.get("batch_stats", {}), 2),
          port.net_d.state_dict())
