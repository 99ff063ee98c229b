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
``strict=False`` merge), named on stderr. Converting an orbax checkpoint
needs orbax (and so JAX) and is still to port (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

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


def modified_resnet_from_flax(params: Mapping, batch_stats: Mapping,
                              layers: Sequence[int] = (3, 4, 6, 3)
                              ) -> StateDict:
    """Flax ``ModifiedResNet`` (params, batch_stats) -> port state dict."""
    sd: StateDict = {}
    for i in (1, 2, 3):
        _conv(sd, f"conv{i}", params[f"conv{i}"])
        _bn(sd, f"bn{i}", params[f"bn{i}"], batch_stats[f"bn{i}"])
    for stage, blocks in enumerate(layers, start=1):
        for b in range(blocks):
            p, s = params[f"layer{stage}_{b}"], batch_stats[f"layer{stage}_{b}"]
            pre = f"layer{stage}.{b}"
            for i in (1, 2, 3):
                _conv(sd, f"{pre}.conv{i}", p[f"conv{i}"])
                _bn(sd, f"{pre}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
            if "downsample_conv" in p:
                _conv(sd, f"{pre}.downsample.0", p["downsample_conv"])
                _bn(sd, f"{pre}.downsample.1", p["downsample_bn"],
                    s["downsample_bn"])
    attn = params["attnpool"]
    sd["attnpool.positional_embedding"] = _t(attn["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(sd, f"attnpool.{name}", attn[name])
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
