"""Adaptive instance normalization and CORAL colour alignment (NCHW).

Counterpart of ``art_sbir_tpu/ops/adain.py`` (reference
`artwork_gen_utils/function.py:4-67`), in the reference's own layout:
feature maps (N, C, H, W), images for :func:`coral` (3, H, W).
Per-channel statistics reduce over the spatial axes with the *unbiased*
variance, as ``torch.Tensor.var``'s default in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(N, C) spatial mean and std of an NCHW feature map, each
    (N, C, 1, 1): the unbiased variance plus ``eps``, then the square root
    (JAX ``adain.py:17-29``)."""
    n, c = feat.shape[:2]
    x = feat.reshape(n, c, -1)
    var = torch.var(x, dim=2, correction=1) + eps
    return x.mean(dim=2)[:, :, None, None], var.sqrt()[:, :, None, None]


def adaptive_instance_normalization(content_feat: torch.Tensor,
                                    style_feat: torch.Tensor,
                                    eps: float = 1e-5) -> torch.Tensor:
    """AdaIN: content features re-normalized to the style features'
    statistics (reference `function.py:16-24`)."""
    style_mean, style_std = calc_mean_std(style_feat, eps)
    content_mean, content_std = calc_mean_std(content_feat, eps)
    normalized = (content_feat - content_mean) / content_std
    return normalized * style_std + style_mean


def _flatten_mean_std(feat: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(3, H, W) image -> (3, HW) and its per-channel mean and unbiased
    std, each (3, 1)."""
    flat = feat.reshape(3, -1)
    return (flat, flat.mean(dim=-1, keepdim=True),
            flat.std(dim=-1, correction=1, keepdim=True))


def _mat_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``u diag(sqrt(d)) v^T`` by SVD. The singular vectors' signs differ
    between libraries; the product does not."""
    u, d, vh = torch.linalg.svd(x)
    return (u * d.sqrt()[None, :]) @ vh


def coral(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """CORAL colour alignment of a (3, H, W) source image to a target
    (reference `function.py:40-67`)."""
    eye = torch.eye(3, dtype=source.dtype, device=source.device)
    src_f, src_mean, src_std = _flatten_mean_std(source)
    src_norm = (src_f - src_mean) / src_std
    src_cov = src_norm @ src_norm.T + eye

    tgt_f, tgt_mean, tgt_std = _flatten_mean_std(target)
    tgt_norm = (tgt_f - tgt_mean) / tgt_std
    tgt_cov = tgt_norm @ tgt_norm.T + eye

    transfer = _mat_sqrt(tgt_cov) @ (torch.linalg.inv(_mat_sqrt(src_cov))
                                     @ src_norm)
    return (transfer * tgt_std + tgt_mean).reshape(source.shape)
