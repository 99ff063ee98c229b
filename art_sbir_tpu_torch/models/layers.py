"""Shared building blocks with torch-parity semantics (NCHW).

Counterpart of ``art_sbir_tpu/models/layers.py``: the BatchNorm momentum,
reflection padding and instance norm with torch's defaults (every
family's fresh init is JAX's own: ``models/flax_families.py``). The JAX
package hand-builds torch's transposed-convolution geometry,
``(in-1)*s - 2p + k + op`` (``layers.py:69-97``); here
``nn.ConvTranspose2d(..., output_padding=...)`` is that geometry
natively, with weights ``(in, out, kh, kw)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# BatchNorm running-stat momentum of the whole model zoo. torch's momentum
# is the weight of the NEW batch statistic; flax's ``BN_MOMENTUM = 0.9``
# is the weight of the OLD running value. The two describe the same update.
BN_MOMENTUM = 0.1


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``nn.ReflectionPad2d(pad)`` on NCHW (JAX ``layers.py:24-26``)."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch ``InstanceNorm2d`` defaults on NCHW: per-(N, C) spatial
    statistics, biased variance, no affine, no running statistics
    (JAX ``layers.py:29-38``). The statistics and the normalization run in
    float32, or in ``x.dtype`` where it is wider (bf16 spatial sums lose
    about three digits), and the result comes back in ``x.dtype``;
    ``F.instance_norm`` on a bf16 input would not match JAX's ``--bf16``."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(xf, dim=(2, 3), keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class InstanceNorm(nn.Module):
    """:func:`instance_norm` as a parameter-free module: it holds no
    state-dict entry, as torch's ``InstanceNorm2d(affine=False)`` holds
    none, so a Sequential keeps the reference's indices."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)
