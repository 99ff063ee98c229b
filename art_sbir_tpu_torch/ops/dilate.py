"""Morphological dilation on the device.

Counterpart of ``art_sbir_tpu/ops/dilate.py`` (JAX ``dilate.py:17-60``).
Two variants the reference uses:

* scipy's ``binary_dilation`` with the default 4-connected cross
  structure, inside the stroke rasterizer (reference `rasterize.py:38,147`);
* cv2's 4x4 all-ones dilation and a threshold at 250, which the
  ``dilate`` CLI uses to thicken thin synthetic sketches (reference
  `transformations.py:68-91`).

Both take (..., H, W) tensors and compute exactly, so they equal the JAX
package's bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_dilate_cross(img: torch.Tensor) -> torch.Tensor:
    """``scipy.ndimage.binary_dilation`` with its default structure on
    (..., H, W): out = m | up | down | left | right, zero borders, bool."""
    m = img.bool()
    out = m.clone()
    out[..., 1:, :] |= m[..., :-1, :]
    out[..., :-1, :] |= m[..., 1:, :]
    out[..., :, 1:] |= m[..., :, :-1]
    out[..., :, :-1] |= m[..., :, 1:]
    return out


def dilate_maxpool(img: torch.Tensor, ksize: int = 4) -> torch.Tensor:
    """``cv2.dilate`` with a ksize x ksize all-ones kernel on (..., H, W).

    cv2 anchors the kernel at a = ksize // 2 and reflects it about the
    anchor: out(y, x) = max of img[y - a .. y + (k - 1 - a)] over both
    axes, so an even ksize pads (a, k - 1 - a), 4 -> (2, 1). Borders
    replicate (cv2's default for dilation). ``F.pad``'s replicate mode
    wants a 4-D float tensor, so integer input goes through float32
    (float64 past 16 bits, where float32 would round) and back; every
    step is exact."""
    a = ksize // 2
    lo, hi = a, ksize - 1 - a
    if img.is_floating_point():
        work = img.dtype
    else:
        work = torch.float32 if img.element_size() <= 2 else torch.float64
    shape = img.shape
    x = img.reshape(-1, 1, shape[-2], shape[-1]).to(work)
    x = F.pad(x, (lo, hi, lo, hi), mode="replicate")
    out = F.max_pool2d(x, ksize, stride=1)
    return out.reshape(shape).to(img.dtype)


def dilate_binarize(img: torch.Tensor, ksize: int = 4,
                    threshold: int = 250) -> torch.Tensor:
    """The reference ``dilate`` CLI body (reference
    `transformations.py:80-91`): grayscale dilation, then a threshold at
    250 -> {0, 255} uint8."""
    d = dilate_maxpool(img.to(torch.float32), ksize)
    return torch.where(d > threshold, 255, 0).to(torch.uint8)
