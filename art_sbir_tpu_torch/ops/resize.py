"""Bicubic resize and CLIP/ImageNet normalization, PIL-parity, as two
matmuls.

Counterpart of ``art_sbir_tpu/ops/resize.py``. The reference
preprocesses every image with torchvision ``Resize(..., BICUBIC)`` on PIL
images and CLIP normalization (reference `models.py:289-295`,
`transformations.py:9-15`). PIL's resample is a separable convolution
with Keys-cubic (a = -0.5) antialiased coefficients: the per-axis
coefficient matrices are built on the host (float64, then float32) and
the resize is ``W_v @ img @ W_h^T``, channel-last as in the JAX package
(the encoder's public input is NHWC). The matmuls run in float32 (TF32
off where the caller keeps torch's default).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)  # reference models.py:294
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)  # reference utils.py:124
IMAGENET_STD = (0.229, 0.224, 0.225)


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic kernel, PIL's `bicubic_filter`."""
    x = np.abs(x)
    return np.where(
        x < 1,
        ((a + 2) * x - (a + 3)) * x * x + 1,
        np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) PIL-style antialiased bicubic coefficient matrix (float64
    computation, float32 result). Mirrors PIL `precompute_coeffs`."""
    support_base = 2.0  # bicubic
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support_base * filterscale
    ss = 1.0 / filterscale
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support), 0)
        xmax = min(int(np.ceil(center + support)), in_size)
        xs = np.arange(xmin, xmax)
        k = _bicubic((xs - center + 0.5) * ss)
        w[i, xmin:xmax] = k / k.sum()
    return w.astype(np.float32)


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int,
                   emulate_uint8: bool = False) -> torch.Tensor:
    """(..., H, W, C) float -> (..., out_h, out_w, C).

    ``emulate_uint8=False``: PIL float('F')-path parity, no clamping.
    ``emulate_uint8=True``: PIL's uint8 image path, which runs the
    horizontal pass first and rounds and clamps to [0, 255] between and
    after the passes (cubic overshoot is clipped); the input must be
    0..255-scaled."""
    h, w = img.shape[-3], img.shape[-2]
    kw = dict(dtype=img.dtype, device=img.device)
    wv = torch.as_tensor(resize_matrix(h, out_h)).to(**kw)  # (out_h, H)
    wh = torch.as_tensor(resize_matrix(w, out_w)).to(**kw)  # (out_w, W)
    hi = torch.einsum("ow,...hwc->...hoc", wh, img)
    if emulate_uint8:
        hi = torch.clamp(torch.round(hi), 0.0, 255.0)
    out = torch.einsum("oh,...hwc->...owc", wv, hi)
    if emulate_uint8:
        out = torch.clamp(torch.round(out), 0.0, 255.0)
    return out


def shortest_side_size(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision Resize(int) semantics: shortest side -> size, other side
    scaled with int() truncation."""
    if h <= w:
        return size, int(size * w / h)
    return int(size * h / w), size


def center_crop_slices(h: int, w: int, crop: int) -> Tuple[int, int]:
    """torchvision CenterCrop offsets (round, matching F.center_crop)."""
    top = int(round((h - crop) / 2.0))
    left = int(round((w - crop) / 2.0))
    return top, left


def resize_center_crop(img: torch.Tensor, size: int,
                       emulate_uint8: bool = False) -> torch.Tensor:
    """Resize(shortest=size) -> CenterCrop(size), the ModifiedResNet
    transform (reference `models.py:289-292`), on (..., H, W, C)."""
    h, w = img.shape[-3], img.shape[-2]
    nh, nw = shortest_side_size(h, w, size)
    out = resize_bicubic(img, nh, nw, emulate_uint8)
    top, left = center_crop_slices(nh, nw, size)
    return out[..., top:top + size, left:left + size, :]


def normalize(img: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """(..., C) channel-last normalize; input in [0, 1]."""
    m = torch.tensor(mean, dtype=img.dtype, device=img.device)
    s = torch.tensor(std, dtype=img.dtype, device=img.device)
    return (img - m) / s


def clip_preprocess(img_uint8: torch.Tensor, size: int = 224,
                    crop: bool = False) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> CLIP-normalized float32 (..., size, size, 3).

    ``crop=False`` mirrors `image_transformV1` (an exact (size, size)
    resize, reference transformations.py:9-15); ``crop=True`` mirrors the
    model's own transform (shortest side, then a center crop, reference
    models.py:289-295)."""
    x = img_uint8.to(torch.float32)
    if crop:
        x = resize_center_crop(x, size, emulate_uint8=True)
    else:
        x = resize_bicubic(x, size, size, emulate_uint8=True)
    return normalize(x / 255.0, CLIP_MEAN, CLIP_STD)
