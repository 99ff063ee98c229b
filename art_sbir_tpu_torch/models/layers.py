"""Shared building blocks with torch-parity semantics (NCHW).

Counterpart of ``art_sbir_tpu/models/layers.py``: the BatchNorm momentum,
reflection padding, instance norm with torch's defaults, and a seeded
form of torch's default convolution init. The JAX package hand-builds
torch's transposed-convolution geometry, ``(in-1)*s - 2p + k + op``
(``layers.py:69-97``); here ``nn.ConvTranspose2d(..., output_padding=...)``
is that geometry natively, with weights ``(in, out, kh, kw)``.
"""

from __future__ import annotations

import math

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


class Conv2d(nn.Conv2d):
    """A conv whose float32 weight and bias are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class InstanceNorm(nn.Module):
    """:func:`instance_norm` as a parameter-free module: it holds no
    state-dict entry, as torch's ``InstanceNorm2d(affine=False)`` holds
    none, so a Sequential keeps the reference's indices."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


@torch.no_grad()
def torch_default_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """torch's own init of every ``Conv2d`` and ``ConvTranspose2d`` (kaiming
    uniform with ``a = sqrt(5)``, bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)))
    drawn from an explicit CPU ``torch.Generator`` seeded with ``seed``, so
    the weights are the same on every device. It stands in for the JAX
    package's ``model.init(jax.random.key(seed))``, whose stream cannot be
    matched."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5), generator=gen)
            if mod.bias is not None:
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(mod.weight)
                bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
                nn.init.uniform_(mod.bias, -bound, bound, generator=gen)
    return model
