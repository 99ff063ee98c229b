"""Carry ModifiedResNet weights across from the JAX package's flax trees.

The inverse of ``art_sbir_tpu/models/torch_port.py::port_modified_resnet``:
flax trees (nested dicts of numpy arrays) -> the port's state dict in the
reference torch layout. Conv ``(kh, kw, in, out)`` -> ``(out, in, kh, kw)``;
dense ``(in, out)`` -> ``(out, in)``; BN ``scale/bias`` + ``mean/var`` ->
``weight/bias/running_mean/running_var``. Converting an orbax checkpoint
needs orbax (and so JAX) and is still to port.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _conv(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                             (3, 2, 0, 1)))


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
