"""The JAX package's fresh inits of every model family but the triplet
encoder, drawn without JAX.

Each family's flax ``model.init`` is a pure function of its key, as the
encoder's is (``models/flax_draw.py`` draws that one and holds the
machinery: flax's key of a parameter from its scope path and count,
the initializers, the draw on the host's threads). Here each family is
one spec, its flax tree's leaves in creation order (path, leaf,
initializer, shape), checked against ``model.init`` in
``tests/test_torch_init.py``; the tree is carried into the port's layout
by ``models/port_weights.py``'s ``*_from_flax``. The keys are those the
JAX CLIs use:

* pix2pix (JAX ``models/pix2pix.py``): ``kg, kd = split(key(seed))``
  (JAX ``train/gan.py:79``), G from ``kg`` and D from ``kd``; kernels
  ``normal(0.02)``, BatchNorm scales ``1 + 0.02 * normal`` under
  ``Norm_k/BatchNorm_0``, conv biases only under the instance and no
  norms. flax names unnamed children by class, in creation order
  (``Conv_i``, ``Norm_i``, ``ResnetBlock_i``, ``ConvTranspose_i``); the
  U-Net's skip blocks, built innermost first in the generator's scope
  and handed down as ``submodule``, sit flat under it as
  ``UnetSkipBlock_0`` (innermost) to ``UnetSkipBlock_{n-1}``.
* the Photo2Sketch VAE (JAX ``models/photo2sketch.py``): ``key(seed)``
  itself (JAX ``train/vae.py:91``). The LSTM's four leaves share one
  scope (counts 1-4), each ``uniform(0, 2k)``; the port stores
  ``param - k``. The decoder's leaves made inside its ``nn.scan``
  (``split_rngs={"params": False}``) take the keys of their paths, as
  outside it.
* the drawing generator and ``GlobalGenerator2`` (JAX
  ``models/drawing.py``): ``key(0)`` (JAX ``cli/drawings.py:52``);
  flax's default ``lecun_normal`` convs with zero biases, the transposed
  convs ``normal(0.02)``, BatchNorm the identity.
* AdaIN (JAX ``models/adain_net.py``): the encoder from ``key(0)``, the
  decoder from ``key(1)`` (JAX ``cli/artwork_gen.py:49-50``).
* InceptionV3 (JAX ``models/inception.py``): ``BasicConv2d_i`` numbered
  in creation order in each block, ``AuxLogits`` (made by a train-mode
  init only: a leaf's key is a function of its path, so the eval-mode
  init's leaves are the same values).
* the CLIP block (JAX ``models/transformer.py``): ``DenseGeneral`` draws
  q, k, v and out in their flat 2-D shapes (``lecun_normal``'s fan_in
  is the flat one's), kept flat here; LayerNorm scale 1, bias 0.

Each function returns the port's state dict (CPU, float32), cached per
configuration and key: callers copy out of it (``load_state_dict``) and
must not write into it.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from art_sbir_tpu_torch.core import jax_random as jr
from art_sbir_tpu_torch.models import flax_draw as FD
from art_sbir_tpu_torch.models.flax_draw import (Leaf, batch_norm, conv,
                                                 conv_transpose, dense)

StateDict = Dict[str, torch.Tensor]
Root = Union[int, Tuple[int, int]]  # a seed, or a key's two words


def _tree(root: Root, spec: List[Leaf]) -> Tuple[dict, dict]:
    words = (jr.key(root) if isinstance(root, int)
             else np.array(root, np.uint32))
    return FD.flax_tree(words, spec)


def pix2pix_keys(seed: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(G's key, D's key) for ``--seed``: ``split(key(seed))``."""
    kg, kd = jr.split(jr.key(seed))
    return tuple(int(w) for w in kg), tuple(int(w) for w in kd)


# ------------------------------------------------------------- pix2pix


def _pix_norm(out: List[Leaf], path, norm: str, c: int) -> None:
    if norm == "batch":
        batch_norm(out, path + ("BatchNorm_0",), c, "bn_scale")


def _resnet_g(input_nc, output_nc, ngf, norm, n_blocks) -> List[Leaf]:
    ub = norm != "batch"
    out: List[Leaf] = []
    conv(out, ("Conv_0",), 7, 7, input_nc, ngf, ub, "normal")
    _pix_norm(out, ("Norm_0",), norm, ngf)
    c = ngf
    for i in (1, 2):  # downsampling
        conv(out, (f"Conv_{i}",), 3, 3, c, c * 2, ub, "normal")
        _pix_norm(out, (f"Norm_{i}",), norm, c * 2)
        c *= 2
    for b in range(n_blocks):
        for j in range(2):
            block = (f"ResnetBlock_{b}",)
            conv(out, block + (f"Conv_{j}",), 3, 3, c, c, ub, "normal")
            _pix_norm(out, block + (f"Norm_{j}",), norm, c)
    for i in range(2):  # upsampling
        conv_transpose(out, (f"ConvTranspose_{i}",), 3, c, c // 2, ub)
        _pix_norm(out, (f"Norm_{3 + i}",), norm, c // 2)
        c //= 2
    conv(out, ("Conv_3",), 7, 7, c, output_nc, True, "normal")
    return out


def _unet_g(input_nc, output_nc, ngf, norm, num_downs) -> List[Leaf]:
    ub = norm != "batch"
    # (outer, inner) channels of each block, innermost first
    levels = ([(ngf * 8, ngf * 8)] * (num_downs - 4)
              + [(ngf * 4, ngf * 8), (ngf * 2, ngf * 4), (ngf, ngf * 2),
                 (output_nc, ngf)])
    out: List[Leaf] = []
    for i, (outer, inner) in enumerate(levels):
        innermost, outermost = i == 0, i == num_downs - 1
        block = (f"UnetSkipBlock_{i}",)
        conv(out, block + ("Conv_0",), 4, 4,
             input_nc if outermost else outer, inner, ub, "normal")
        norms = []
        if not (innermost or outermost):
            norms.append(inner)
        conv_transpose(out, block + ("ConvTranspose_0",), 4,
                       inner if innermost else inner * 2, outer,
                       ub or outermost)
        if not outermost:
            norms.append(outer)
        for j, c in enumerate(norms):
            _pix_norm(out, block + (f"Norm_{j}",), norm, c)
    return out


@functools.lru_cache(maxsize=8)
def pix2pix_g(root: Root, net_g: str, input_nc: int = 3, output_nc: int = 1,
              ngf: int = 64, norm: str = "batch", n_blocks: int = 9,
              num_downs: int = 8) -> StateDict:
    """JAX's init of ``define_g(net_g, ...)`` ("resnet_9blocks", with
    ``n_blocks`` for thinner test models, or "unet_256", ``num_downs``)
    in the port's layout."""
    from art_sbir_tpu_torch.models import port_weights as PW

    if net_g == "resnet_9blocks":
        spec = _resnet_g(input_nc, output_nc, ngf, norm, n_blocks)
    elif net_g == "unet_256":
        spec = _unet_g(input_nc, output_nc, ngf, norm, num_downs)
    else:
        raise NotImplementedError(f"generator {net_g}")
    return PW.pix2pix_g_from_flax(net_g, *_tree(root, spec), n_blocks,
                                  num_downs)


@functools.lru_cache(maxsize=8)
def pix2pix_d(root: Root, net_d: str, input_nc: int = 4, ndf: int = 64,
              norm: str = "batch", n_layers: int = 3) -> StateDict:
    """JAX's init of ``define_d(net_d, ...)`` ("basic", "n_layers" with
    ``n_layers``, or "pixel") in the port's layout."""
    from art_sbir_tpu_torch.models import port_weights as PW

    ub = norm != "batch"
    out: List[Leaf] = []
    if net_d == "pixel":
        conv(out, ("Conv_0",), 1, 1, input_nc, ndf, True, "normal")
        conv(out, ("Conv_1",), 1, 1, ndf, ndf * 2, ub, "normal")
        _pix_norm(out, ("Norm_0",), norm, ndf * 2)
        conv(out, ("Conv_2",), 1, 1, ndf * 2, 1, ub, "normal")
    else:
        n = 3 if net_d == "basic" else n_layers
        conv(out, ("Conv_0",), 4, 4, input_nc, ndf, True, "normal")
        nf = 1
        for i in range(1, n + 1):
            prev, nf = nf, min(2 ** i, 8)
            conv(out, (f"Conv_{i}",), 4, 4, ndf * prev, ndf * nf, ub,
                 "normal")
            _pix_norm(out, (f"Norm_{i - 1}",), norm, ndf * nf)
        conv(out, (f"Conv_{n + 1}",), 4, 4, ndf * nf, 1, True, "normal")
    return PW.pix2pix_d_from_flax(net_d, *_tree(root, out), n_layers)


def pix2pix(root: Root, net: torch.nn.Module) -> StateDict:
    """JAX's init of the port's pix2pix G or D ``net``, its configuration
    read off it (``net.geometry``)."""
    from art_sbir_tpu_torch.models import pix2pix as PP

    if isinstance(net, PP.ResnetGenerator):
        return pix2pix_g(root, "resnet_9blocks", **net.geometry)
    if isinstance(net, PP.UnetGenerator):
        return pix2pix_g(root, "unet_256", **net.geometry)
    if isinstance(net, PP.NLayerDiscriminator):
        return pix2pix_d(root, "n_layers", **net.geometry)
    return pix2pix_d(root, "pixel", **net.geometry)


# ------------------------------------------------------------ the VAE


@functools.lru_cache(maxsize=4)
def photo2sketch(root: Root, z_size: int = 128, dec_rnn_size: int = 512,
                 num_mixture: int = 20) -> StateDict:
    """JAX's init of ``Photo2Sketch(z_size, dec_rnn_size, num_mixture)``
    (VGG16's features, the heads, the attention LSTM decoder)."""
    from art_sbir_tpu_torch.models import port_weights as PW
    from art_sbir_tpu_torch.models.photo2sketch import EMBEDDING, FEATURES
    from art_sbir_tpu_torch.models.vgg import VGG16_CFG

    out: List[Leaf] = []
    enc, dec = ("Image_Encoder",), ("Sketch_Decoder",)
    cin = 3
    for i, v in enumerate(c for c in VGG16_CFG if c != "M"):
        conv(out, enc + ("feature", f"conv{i}"), 3, 3, cin, v)
        cin = v
    dense(out, enc + ("fc_mu",), FEATURES, z_size)
    dense(out, enc + ("fc_std",), FEATURES, z_size)
    hidden = dec_rnn_size
    dense(out, dec + ("fc_hc",), z_size, 2 * hidden)
    att = dec + ("attention_cell",)
    conv(out, att + ("conv_f",), 3, 3, FEATURES, EMBEDDING)
    dense(out, att + ("conv_h",), hidden, EMBEDDING)
    dense(out, att + ("conv_att",), EMBEDDING, 1)
    for side, fan in (("ih", FEATURES + 5), ("hh", hidden)):
        out.append((dec + ("lstm",), f"{side}_kernel", "lstm",
                    (fan, 4 * hidden)))
        out.append((dec + ("lstm",), f"{side}_bias", "lstm", (4 * hidden,)))
    dense(out, dec + ("fc_params",), hidden, 6 * num_mixture + 3)
    return PW.photo2sketch_from_flax(_tree(root, out)[0])


# ------------------------------------------------ the drawing generators


@functools.lru_cache(maxsize=4)
def drawing_generator(root: Root = 0, input_nc: int = 3, output_nc: int = 1,
                      n_residual_blocks: int = 3) -> StateDict:
    """JAX's init of ``DrawingGenerator``."""
    from art_sbir_tpu_torch.models import port_weights as PW

    out: List[Leaf] = []
    conv(out, ("stem",), 7, 7, input_nc, 64)
    c = 64
    for i in range(2):
        conv(out, (f"down{i}",), 3, 3, c, c * 2)
        c *= 2
    for i in range(n_residual_blocks):
        for j in range(2):
            conv(out, (f"res{i}", f"Conv_{j}"), 3, 3, c, c)
    for i in range(2):
        conv_transpose(out, (f"up{i}",), 3, c, c // 2)
        c //= 2
    conv(out, ("head",), 7, 7, c, output_nc)
    return PW.drawing_from_flax(_tree(root, out)[0], n_residual_blocks)


@functools.lru_cache(maxsize=4)
def global_generator2(root: Root = 0, input_nc: int = 3, output_nc: int = 3,
                      ngf: int = 64, n_downsampling: int = 3,
                      n_blocks: int = 9, n_upsampling: int = 0
                      ) -> StateDict:
    """JAX's init of ``GlobalGenerator2``: its convs, transposed convs and
    BatchNorms auto-named by class in creation order, in the port's
    ``model.<i>`` layout."""
    from art_sbir_tpu_torch.models import port_weights as PW

    out: List[Leaf] = []
    n = {"Conv": 0, "ConvTranspose": 0, "BatchNorm": 0}

    def name(kind: str) -> Tuple[str]:
        n[kind] += 1
        return (f"{kind}_{n[kind] - 1}",)

    mult = 8
    conv(out, name("Conv"), 7, 7, input_nc, ngf * mult)
    batch_norm(out, name("BatchNorm"), ngf * mult)
    for _ in range(n_downsampling):
        conv_transpose(out, name("ConvTranspose"), 4, ngf * mult,
                       ngf * mult // 2)
        batch_norm(out, name("BatchNorm"), ngf * mult // 2)
        mult //= 2
    for _ in range(n_blocks):
        for _ in range(2):
            conv(out, name("Conv"), 3, 3, ngf * mult, ngf * mult)
            batch_norm(out, name("BatchNorm"), ngf * mult)
    for _ in range(n_upsampling if n_upsampling > 0 else n_downsampling):
        nxt = mult // 2 or 1
        conv_transpose(out, name("ConvTranspose"), 3, ngf * mult, ngf * nxt)
        batch_norm(out, name("BatchNorm"), ngf * nxt)
        mult = nxt
    conv(out, name("Conv"), 7, 7, ngf * mult, output_nc)
    return PW.global_generator2_from_flax(
        *_tree(root, out), n_downsampling=n_downsampling, n_blocks=n_blocks,
        n_upsampling=n_upsampling)


# ------------------------------------------------------------- AdaIN


@functools.lru_cache(maxsize=2)
def adain(encoder_root: Root = 0, decoder_root: Root = 1
          ) -> Tuple[StateDict, StateDict]:
    """JAX's inits of ``AdaINEncoder`` and ``AdaINDecoder``, in the
    ``vgg_normalised.pth`` and ``decoder.pth`` layouts."""
    from art_sbir_tpu_torch.models import port_weights as PW
    from art_sbir_tpu_torch.models.adain_net import _DEC_PLAN, _ENC_PLAN

    enc: List[Leaf] = []
    conv(enc, ("proj",), 1, 1, 3, 3)
    cin = 3
    for i, (feats, _) in enumerate(_ENC_PLAN):
        conv(enc, (f"conv{i}",), 3, 3, cin, feats)
        cin = feats
    dec: List[Leaf] = []
    cin = 512  # relu4_1's channels
    for i, (feats, _) in enumerate(_DEC_PLAN):
        conv(dec, (f"conv{i}",), 3, 3, cin, feats)
        cin = feats
    conv(dec, ("out",), 3, 3, cin, 3)
    return PW.adain_from_flax(_tree(encoder_root, enc)[0],
                              _tree(decoder_root, dec)[0])


# ------------------------------------------------------- InceptionV3


def _basic_convs(block: torch.nn.Module):
    """(cin, cout, kh, kw) of each BasicConv2d child of ``block``, in
    creation order."""
    for child in block.children():
        c = child.conv
        yield (c.in_channels, c.out_channels) + tuple(c.kernel_size)


def _basic_conv(out: List[Leaf], path, cin, cout, kh, kw) -> None:
    conv(out, path + ("Conv_0",), kh, kw, cin, cout, bias=False)
    batch_norm(out, path + ("BatchNorm_0",), cout)


@functools.lru_cache(maxsize=2)
def inception_v3(root: Root = 0, num_classes: int = 1000,
                 aux: bool = True) -> StateDict:
    """JAX's init of ``InceptionV3(num_classes)``, with the train-mode
    init's ``AuxLogits`` where ``aux``."""
    from art_sbir_tpu_torch.models import port_weights as PW
    from art_sbir_tpu_torch.models.inception import (MIXED, STEM,
                                                     InceptionAux)

    out: List[Leaf] = []
    for i, (_, cin, cout, k, _, _) in enumerate(STEM):
        _basic_conv(out, (f"BasicConv2d_{i}",), cin, cout, k, k)
    seen: Dict[str, int] = {}
    for _, block, args in MIXED:
        kind = block.__name__
        path = (f"{kind}_{seen.get(kind, 0)}",)
        seen[kind] = seen.get(kind, 0) + 1
        with torch.device("meta"):  # the children's shapes, no weights
            shapes = list(_basic_convs(block(*args)))
        for j, shape in enumerate(shapes):
            _basic_conv(out, path + (f"BasicConv2d_{j}",), *shape)
    if aux:
        with torch.device("meta"):
            head = InceptionAux(768, num_classes)
        for j, shape in enumerate(_basic_convs(torch.nn.Sequential(
                head.conv0, head.conv1))):
            _basic_conv(out, ("AuxLogits", f"BasicConv2d_{j}"), *shape)
        dense(out, ("AuxLogits", "Dense_0"), 768, num_classes)
    dense(out, ("fc",), 2048, num_classes)
    return PW.inception_v3_from_flax(*_tree(root, out))


# -------------------------------------------------------- the CLIP block


@functools.lru_cache(maxsize=2)
def residual_attention_block(root: Root, d_model: int) -> StateDict:
    """JAX's init of ``ResidualAttentionBlock(d_model, n_head)``, any
    ``n_head``: the flat draws do not depend on it."""
    from art_sbir_tpu_torch.models import port_weights as PW

    out: List[Leaf] = []
    d = d_model
    for ln in ("ln_1", "ln_2"):
        out.append(((ln, "LayerNorm_0"), "scale", "ones", (d,)))
        out.append(((ln, "LayerNorm_0"), "bias", "zeros", (d,)))
    for name in ("query", "key", "value", "out"):
        dense(out, ("attn", name), d, d)
    dense(out, ("c_fc",), d, 4 * d)
    dense(out, ("c_proj",), 4 * d, d)
    return PW.residual_attention_block_from_flax(_tree(root, out)[0])


def seed0_draws() -> Dict[str, Callable[[], StateDict]]:
    """Each family's seed-0 fresh init at the full width its entry point
    draws (``Pix2Pix(Pix2PixConfig(), 0)``'s nets, ``VAETrainer`` at
    ``VAEConfig``'s defaults, the drawing and AdaIN CLIs without
    ``--model``, the AdaIN pair under ``encoder.`` and ``decoder.``,
    ``create_inception()``, the CLIP block at width 512), a function each:
    the subjects of ``goldens/torch_jax_init_families_seed0.json``."""
    kg, kd = pix2pix_keys(0)

    def adain_pair() -> StateDict:
        enc, dec = adain(0, 1)
        return {**{f"encoder.{k}": v for k, v in enc.items()},
                **{f"decoder.{k}": v for k, v in dec.items()}}

    return {"pix2pix_g": lambda: pix2pix_g(kg, "resnet_9blocks"),
            "pix2pix_d": lambda: pix2pix_d(kd, "basic"),
            "photo2sketch": lambda: photo2sketch(0),
            "drawing_generator": lambda: drawing_generator(0),
            "adain": adain_pair,
            "inception_v3": lambda: inception_v3(0),
            "clip_block": lambda: residual_attention_block(0, 512)}


def clear_caches() -> None:
    """Forget every cached draw (so the next one is timed whole)."""
    for fn in (pix2pix_g, pix2pix_d, photo2sketch, drawing_generator,
               global_generator2, adain, inception_v3,
               residual_attention_block):
        fn.cache_clear()
