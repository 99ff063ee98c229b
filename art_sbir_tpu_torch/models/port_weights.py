"""Carry weights across from the JAX package's flax trees, and load the
reference's published ``.pth`` files.

The ``*_from_flax`` functions are the inverses of
``art_sbir_tpu/models/torch_port.py::port_*``: flax trees (nested dicts of
numpy arrays) -> the port's state dicts in the reference torch layout.
Conv ``(kh, kw, in, out)`` and transposed conv ``(kh, kw, out, in)`` ->
``(out, in, kh, kw)`` and ``(in, out, kh, kw)``; dense ``(in, out)`` ->
``(out, in)``; BN ``scale/bias`` + ``mean/var`` ->
``weight/bias/running_mean/running_var``.

The ``.pth`` loaders follow ``art_sbir_tpu/cli/port.py:36-41,76-160``: a
whole-module pickle is unwrapped with ``.state_dict()``, and a key the
file lacks keeps the model's fresh value (the JAX package's
``strict=False`` merge), named on stderr. ``scripts/orbax_to_pt.py``
restores the JAX package's orbax exports (it needs orbax, and so JAX) and
writes them through these functions as the port's ``.pt`` files.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from art_sbir_tpu_torch.models import inception
from art_sbir_tpu_torch.models.vgg import CONV_INDICES

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _conv(sd: StateDict, prefix: str, p: Mapping) -> None:
    """A conv, or a transposed conv: both kernels go (3, 2, 0, 1)."""
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                             (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _dense(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"])))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd: StateDict, prefix: str, p: Mapping, s: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _resnet_norms(tree: Mapping, layers: Sequence[int]):
    """(port prefix, flax subtree) of each BatchNorm of a flax
    ``ModifiedResNet`` tree, its params or its batch_stats."""
    for i in (1, 2, 3):
        yield f"bn{i}", tree[f"bn{i}"]
    for stage, blocks in enumerate(layers, start=1):
        for b in range(blocks):
            t, pre = tree[f"layer{stage}_{b}"], f"layer{stage}.{b}"
            for i in (1, 2, 3):
                yield f"{pre}.bn{i}", t[f"bn{i}"]
            if "downsample_bn" in t:
                yield f"{pre}.downsample.1", t["downsample_bn"]


def modified_resnet_from_flax(params: Mapping, batch_stats: Mapping,
                              layers: Sequence[int] = (3, 4, 6, 3)
                              ) -> StateDict:
    """Flax ``ModifiedResNet`` (params, batch_stats) -> port state dict."""
    sd: StateDict = {}
    for i in (1, 2, 3):
        _conv(sd, f"conv{i}", params[f"conv{i}"])
    for stage, blocks in enumerate(layers, start=1):
        for b in range(blocks):
            p, pre = params[f"layer{stage}_{b}"], f"layer{stage}.{b}"
            for i in (1, 2, 3):
                _conv(sd, f"{pre}.conv{i}", p[f"conv{i}"])
            if "downsample_conv" in p:
                _conv(sd, f"{pre}.downsample.0", p["downsample_conv"])
    for (prefix, p), (_, s) in zip(_resnet_norms(params, layers),
                                   _resnet_norms(batch_stats, layers)):
        _bn(sd, prefix, p, s)
    attn = params["attnpool"]
    sd["attnpool.positional_embedding"] = _t(attn["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(sd, f"attnpool.{name}", attn[name])
    return sd


def modified_resnet_stats_from_flax(batch_stats: Mapping,
                                    layers: Sequence[int] = (3, 4, 6, 3)
                                    ) -> StateDict:
    """A flax ``ModifiedResNet``'s batch_stats alone (the JAX trainer's
    ``<run>_bn_sketch`` export) -> the port's statistics dict
    (``<layer>.running_mean`` and ``running_var``: ``train/bn.py``'s
    layout, which ``models/<run>_bn_sketch.pt`` holds)."""
    sd: StateDict = {}
    for prefix, s in _resnet_norms(batch_stats, layers):
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])
    return sd


def modified_resnet_with_classification_from_flax(
        params: Mapping, batch_stats: Mapping,
        layers: Sequence[int] = (3, 4, 6, 3)) -> StateDict:
    """Flax ``ModifiedResNetWithClassification`` -> port state dict: the
    backbone at top level (the reference layout), plus ``classifier`` and,
    with two heads, ``classifier2``."""
    sd = modified_resnet_from_flax(params["backbone"],
                                   batch_stats["backbone"], layers)
    for name in ("classifier", "classifier2"):
        if name in params:
            _dense(sd, name, params[name])
    return sd


def drawing_from_flax(params: Mapping, n_residual_blocks: int = 3
                      ) -> StateDict:
    """Flax ``DrawingGenerator`` params -> the reference ``Generator``
    layout (the inverse of JAX ``torch_port.py::port_drawing_generator``)."""
    sd: StateDict = {}
    _conv(sd, "model0.1", params["stem"])
    for i in range(2):
        _conv(sd, f"model1.{i * 3}", params[f"down{i}"])
    for i in range(n_residual_blocks):
        _conv(sd, f"model2.{i}.conv_block.1", params[f"res{i}"]["Conv_0"])
        _conv(sd, f"model2.{i}.conv_block.5", params[f"res{i}"]["Conv_1"])
    for i in range(2):
        _conv(sd, f"model3.{i * 3}", params[f"up{i}"])
    _conv(sd, "model4.1", params["head"])
    return sd


ADAIN_ENCODER_CONVS = (0, 2, 5, 9, 12, 16, 19, 22, 25, 29)
ADAIN_DECODER_CONVS = (1, 5, 8, 11, 14, 18, 21, 25, 28)
ADAIN_ENCODER_LAST = 30  # relu4_1: vgg_normalised.pth's keys past it go


def adain_from_flax(encoder_params: Mapping, decoder_params: Mapping
                    ) -> Tuple[StateDict, StateDict]:
    """Flax ``AdaINEncoder`` and ``AdaINDecoder`` params -> the
    ``vgg_normalised.pth`` and ``decoder.pth`` layouts (the inverse of JAX
    ``torch_port.py::port_adain``)."""
    enc: StateDict = {}
    names = ["proj"] + [f"conv{i}" for i in range(9)]
    for name, t in zip(names, ADAIN_ENCODER_CONVS):
        _conv(enc, str(t), encoder_params[name])
    dec: StateDict = {}
    names = [f"conv{i}" for i in range(8)] + ["out"]
    for name, t in zip(names, ADAIN_DECODER_CONVS):
        _conv(dec, str(t), decoder_params[name])
    return enc, dec


def load_reference_pth(path: Path | str) -> StateDict:
    """A reference ``.pth`` on the CPU. The published files are state dicts
    or whole pickled modules (unwrapped with ``.state_dict()``), so this
    unpickles objects (``weights_only=False``), as the JAX package's
    ``cli/port.py::_load_pth`` does: load only files you trust."""
    loaded = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(loaded, "state_dict"):
        loaded = loaded.state_dict()
    return dict(loaded)


def load_into(model: nn.Module, sd: Mapping[str, torch.Tensor], what: str
              ) -> nn.Module:
    """Load ``sd`` into ``model``. A key of the model that ``sd`` lacks
    keeps its fresh value and is named on stderr; a key ``sd`` holds that
    the model does not raises (the caller drops what it knows to drop)."""
    own = model.state_dict()
    unexpected = sorted(set(sd) - set(own))
    if unexpected:
        raise KeyError(f"{what}: keys not in the model: {unexpected[:8]}")
    missing = sorted(set(own) - set(sd))
    if missing:
        print(f"{what}: {len(missing)} keys missing from the file keep their "
              f"fresh init: {missing[:8]}", file=sys.stderr, flush=True)
    model.load_state_dict({**own, **sd})
    return model


def load_adain_pth(src: str) -> Tuple[StateDict, StateDict]:
    """The published AdaIN pair -> (encoder, decoder) state dicts. ``src``
    is a directory holding ``vgg_normalised.pth`` and ``decoder.pth``, or
    the comma-joined pair. The encoder keeps Sequential indices 0..30
    (through relu4_1): the keys of ``vgg_normalised.pth`` past it
    (relu4_2..relu5_4, unused by style transfer) are dropped here, by
    index, as JAX ``torch_port.py::port_adain`` ignores them."""
    if Path(src).is_dir():
        vgg_path, dec_path = (Path(src) / "vgg_normalised.pth",
                              Path(src) / "decoder.pth")
    else:
        vgg_path, dec_path = src.split(",")
    vgg = {k: v for k, v in load_reference_pth(vgg_path).items()
           if int(k.split(".")[0]) <= ADAIN_ENCODER_LAST}
    return vgg, load_reference_pth(dec_path)


def _norm(sd: StateDict, prefix: str, params: Mapping, stats: Mapping,
          name: str) -> None:
    """A pix2pix ``Norm`` module: batch norm carries its tensors; instance
    and no norm carry none (and flax holds no entry for them)."""
    if name in params:
        _bn(sd, prefix, params[name]["BatchNorm_0"],
            stats[name]["BatchNorm_0"])


def pix2pix_g_from_flax(net_g: str, params: Mapping, batch_stats: Mapping,
                        n_blocks: int = 9, num_downs: int = 8) -> StateDict:
    """Flax ``ResnetGenerator`` (``net_g`` "resnet_9blocks"; ``n_blocks``
    for thinner test models) or ``UnetGenerator`` ("unet_256";
    ``num_downs``) (params, batch_stats) -> the reference layout (the
    inverse of JAX ``torch_port.py::port_resnet_generator`` and
    ``port_unet_generator``)."""
    sd: StateDict = {}
    p, s = params, batch_stats
    if net_g == "resnet_9blocks":
        for i, t in enumerate((1, 4, 7)):  # stem, two downs
            _conv(sd, f"model.{t}", p[f"Conv_{i}"])
            _norm(sd, f"model.{t + 1}", p, s, f"Norm_{i}")
        for b in range(n_blocks):
            pre, bp = f"model.{10 + b}.conv_block", p[f"ResnetBlock_{b}"]
            bs = s.get(f"ResnetBlock_{b}", {})
            for j, t in enumerate((1, 6)):
                _conv(sd, f"{pre}.{t}", bp[f"Conv_{j}"])
                _norm(sd, f"{pre}.{t + 1}", bp, bs, f"Norm_{j}")
        for i, t in enumerate((10 + n_blocks, 13 + n_blocks)):  # ups
            _conv(sd, f"model.{t}", p[f"ConvTranspose_{i}"])
            _norm(sd, f"model.{t + 1}", p, s, f"Norm_{3 + i}")
        _conv(sd, f"model.{17 + n_blocks}", p["Conv_3"])
        return sd
    if net_g != "unet_256":
        raise NotImplementedError(f"generator {net_g}")
    prefix = "model.model"
    for level in range(num_downs):  # 0 = outermost
        name = f"UnetSkipBlock_{num_downs - 1 - level}"
        bp, bs = p[name], s.get(name, {})
        if level == 0:
            down, up, norms, sub = 0, 3, (), 1
        elif level == num_downs - 1:
            down, up, norms, sub = 1, 3, (4,), None
        else:
            down, up, norms, sub = 1, 5, (2, 6), 3
        _conv(sd, f"{prefix}.{down}", bp["Conv_0"])
        _conv(sd, f"{prefix}.{up}", bp["ConvTranspose_0"])
        for j, t in enumerate(norms):
            _norm(sd, f"{prefix}.{t}", bp, bs, f"Norm_{j}")
        if sub is not None:
            prefix = f"{prefix}.{sub}.model"
    return sd


def pix2pix_d_from_flax(net_d: str, params: Mapping, batch_stats: Mapping,
                        n_layers: int = 3) -> StateDict:
    """Flax ``NLayerDiscriminator`` ("basic", or "n_layers" with
    ``n_layers``) or ``PixelDiscriminator`` ("pixel") -> the reference
    layout (the inverse of JAX
    ``torch_port.py::port_patchgan_discriminator``; the PixelGAN's
    ``net.*`` keys have no JAX mapping)."""
    sd: StateDict = {}
    p, s = params, batch_stats
    if net_d == "pixel":
        for i, t in enumerate((0, 2, 5)):
            _conv(sd, f"net.{t}", p[f"Conv_{i}"])
        _norm(sd, "net.3", p, s, "Norm_0")
        return sd
    n = 3 if net_d == "basic" else n_layers
    convs = [0] + [2 + 3 * j for j in range(n + 1)]
    for i, t in enumerate(convs):
        _conv(sd, f"model.{t}", p[f"Conv_{i}"])
    for j in range(n):
        _norm(sd, f"model.{3 + 3 * j}", p, s, f"Norm_{j}")
    return sd


def load_pix2pix_reference(src: Path | str
                           ) -> Tuple[StateDict, StateDict | None]:
    """A reference pix2pix checkpoint -> (G, D or None) state dicts. ``src``
    is a directory holding ``latest_net_G.pth`` and, optionally,
    ``latest_net_D.pth`` (the layout JAX ``cli/port.py::port_pix2pix``
    reads), or a G ``.pth`` alone."""
    src = Path(src)
    if not src.is_dir():
        return load_reference_pth(src), None
    d_path = src / "latest_net_D.pth"
    return (load_reference_pth(src / "latest_net_G.pth"),
            load_reference_pth(d_path) if d_path.exists() else None)


def photo2sketch_from_flax(params: Mapping) -> StateDict:
    """Flax ``Photo2Sketch`` params -> the reference layout (the inverse of
    JAX ``torch_port.py::port_photo2sketch``). JAX's ``TorchLSTMCell``
    stores ``kernel`` (in, 4H) and ``bias`` with the effective weight
    ``kernel - k``, ``k = 1 / sqrt(H)`` (``layers.py:51-60``): the
    ``nn.LSTM``'s ``weight_*_l0`` is ``(kernel - k)^T`` and its
    ``bias_*_l0`` is ``bias - k``, each taken in float32 as JAX's step
    takes it."""
    sd: StateDict = {}
    enc, dec = params["Image_Encoder"], params["Sketch_Decoder"]
    for i, t in enumerate(CONV_INDICES):
        _conv(sd, f"Image_Encoder.feature.{t}", enc["feature"][f"conv{i}"])
    _dense(sd, "Image_Encoder.fc_mu", enc["fc_mu"])
    _dense(sd, "Image_Encoder.fc_std", enc["fc_std"])
    _dense(sd, "Sketch_Decoder.fc_hc", dec["fc_hc"])
    _dense(sd, "Sketch_Decoder.fc_params", dec["fc_params"])
    lstm = dec["lstm"]
    hidden = np.asarray(lstm["hh_kernel"]).shape[0]
    k = np.float32(1.0) / np.sqrt(np.float32(hidden))
    for side in ("ih", "hh"):
        kernel = np.asarray(lstm[f"{side}_kernel"], np.float32) - k
        sd[f"Sketch_Decoder.lstm.weight_{side}_l0"] = _t(kernel.T)
        sd[f"Sketch_Decoder.lstm.bias_{side}_l0"] = _t(
            np.asarray(lstm[f"{side}_bias"], np.float32) - k)
    att = dec["attention_cell"]
    _conv(sd, "Sketch_Decoder.attention_cell.conv_f", att["conv_f"])
    _dense(sd, "Sketch_Decoder.attention_cell.conv_h", att["conv_h"])
    _dense(sd, "Sketch_Decoder.attention_cell.conv_att", att["conv_att"])
    return sd


def _basic_conv(sd: StateDict, prefix: str, p: Mapping, s: Mapping) -> None:
    """A flax ``BasicConv2d`` (``Conv_0``, ``BatchNorm_0``) -> torchvision's
    ``<prefix>.conv`` and ``<prefix>.bn``."""
    _conv(sd, f"{prefix}.conv", p["Conv_0"])
    _bn(sd, f"{prefix}.bn", p["BatchNorm_0"], s["BatchNorm_0"])


def inception_v3_from_flax(params: Mapping, batch_stats: Mapping
                           ) -> StateDict:
    """Flax ``InceptionV3`` (params, batch_stats) -> the port's
    torchvision-layout state dict. Flax names each block by its class
    and call order (``BasicConv2d_0``, ``InceptionA_2``, ...); the call
    order inside each block is torchvision's attribute order, which
    :mod:`~art_sbir_tpu_torch.models.inception` keeps (``AuxLogits`` is
    there only where the tree was made in train mode)."""
    sd: StateDict = {}
    for i, (name, *_) in enumerate(inception.STEM):
        _basic_conv(sd, name, params[f"BasicConv2d_{i}"],
                    batch_stats[f"BasicConv2d_{i}"])
    seen: Dict[str, int] = {}
    for name, block, args in inception.MIXED:
        kind = block.__name__
        flax_name = f"{kind}_{seen.get(kind, 0)}"
        seen[kind] = seen.get(kind, 0) + 1
        with torch.device("meta"):  # the children's names, no weights
            children = [n for n, _ in block(*args).named_children()]
        for j, child in enumerate(children):
            _basic_conv(sd, f"{name}.{child}",
                        params[flax_name][f"BasicConv2d_{j}"],
                        batch_stats[flax_name][f"BasicConv2d_{j}"])
    if "AuxLogits" in params:
        p, s = params["AuxLogits"], batch_stats["AuxLogits"]
        for j, child in enumerate(("conv0", "conv1")):
            _basic_conv(sd, f"AuxLogits.{child}", p[f"BasicConv2d_{j}"],
                        s[f"BasicConv2d_{j}"])
        _dense(sd, "AuxLogits.fc", p["Dense_0"])
    _dense(sd, "fc", params["fc"])
    return sd


def residual_attention_block_from_flax(params: Mapping) -> StateDict:
    """Flax ``ResidualAttentionBlock`` params -> the port's (the
    reference's) keys. ``MultiHeadDotProductAttention``'s q, k and v
    kernels, (D, H, D/H) with (H, D/H) biases, stack into
    ``attn.in_proj_weight`` (3D, D) head-major; its out kernel, (H, D/H,
    D), is ``attn.out_proj``'s (D, D) transposed; the LayerNorms' scale
    and bias are ``ln_*.weight`` and ``.bias``."""
    sd: StateDict = {}
    attn = params["attn"]
    qkv = [np.asarray(attn[n]["kernel"]) for n in ("query", "key", "value")]
    d = qkv[0].shape[0]
    sd["attn.in_proj_weight"] = _t(np.concatenate(
        [k.reshape(d, -1).T for k in qkv]))
    sd["attn.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(attn[n]["bias"]).reshape(-1)
         for n in ("query", "key", "value")]))
    sd["attn.out_proj.weight"] = _t(
        np.asarray(attn["out"]["kernel"]).reshape(-1, d).T)
    sd["attn.out_proj.bias"] = _t(attn["out"]["bias"])
    for ln in ("ln_1", "ln_2"):
        p = params[ln]["LayerNorm_0"]
        sd[f"{ln}.weight"] = _t(p["scale"])
        sd[f"{ln}.bias"] = _t(p["bias"])
    _dense(sd, "mlp.c_fc", params["c_fc"])
    _dense(sd, "mlp.c_proj", params["c_proj"])
    return sd
