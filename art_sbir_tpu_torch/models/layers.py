"""Shared building blocks with torch-parity semantics (NCHW).

Counterpart of ``art_sbir_tpu/models/layers.py``: the BatchNorm momentum,
reflection padding, instance norm with torch's defaults, and a seeded
form of the JAX package's default inits (:func:`flax_init`). The JAX
package hand-builds torch's transposed-convolution geometry,
``(in-1)*s - 2p + k + op`` (``layers.py:69-97``); here
``nn.ConvTranspose2d(..., output_padding=...)`` is that geometry
natively, with weights ``(in, out, kh, kw)``.
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


# std of a standard normal truncated to [-2, 2]: flax's ``lecun_normal``
# divides by it so that the truncated draw keeps variance 1 / fan_in
TRUNC_NORMAL_STD = 0.87962566103423978
CONV_TRANSPOSE_STD = 0.02  # JAX ``layers.py::ConvTranspose``'s kernel_init


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default kernel init ``lecun_normal`` into a conv or linear
    weight (out, in, ...): a normal of std ``sqrt(1 / fan_in) / 0.8796``
    truncated at two of its stds, so the variance is ``1 / fan_in`` and
    ``|w| * sqrt(fan_in) <= 2.2737``. Drawn as ``jax.random.
    truncated_normal`` draws it, by the inverse CDF: a uniform over
    ``(erf(-sqrt(2)), erf(sqrt(2)))``, then ``sqrt(2) * erfinv``, in
    float32 in a contiguous buffer whatever the weight's dtype and memory
    format. (``nn.init.trunc_normal_`` changed its draws between torch
    releases; ``uniform_`` and ``erfinv_`` give the same weights on
    each.)"""
    std = (1.0 / weight[0].numel()) ** 0.5 / TRUNC_NORMAL_STD
    edge = math.erf(2.0 / math.sqrt(2.0))
    draw = torch.empty(weight.shape).uniform_(-edge, edge, generator=gen)
    weight.copy_(draw.erfinv_().mul_(math.sqrt(2.0) * std))


@torch.no_grad()
def flax_init(model: nn.Module, seed: int = 0,
              gen: torch.Generator | None = None) -> nn.Module:
    """The JAX package's fresh-init distributions, module by module, drawn
    from an explicit CPU ``torch.Generator`` (``gen``, else one seeded with
    ``seed``), so the weights are the same on every device:

    * ``Conv2d`` and ``Linear``: :func:`lecun_normal_` with zero bias
      (flax's ``nn.Conv`` and ``nn.Dense`` defaults);
    * ``ConvTranspose2d``: N(0, 0.02) with zero bias (JAX
      ``layers.py::ConvTranspose``);
    * ``LSTM``: every weight and bias U(-k, k), ``k = 1 / sqrt(hidden)``
      (JAX ``layers.py::TorchLSTMCell``, torch's own LSTM init);
    * ``BatchNorm2d``: identity (scale 1, bias 0, statistics 0 and 1).

    The draws cannot equal ``jax.random``'s; the family, scale and
    truncation bound of each tensor do."""
    if gen is None:
        gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.ConvTranspose2d):
            draw = torch.empty(mod.weight.shape)
            mod.weight.copy_(draw.normal_(0.0, CONV_TRANSPOSE_STD,
                                          generator=gen))
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            lecun_normal_(mod.weight, gen)
        elif isinstance(mod, nn.LSTM):
            k = 1.0 / mod.hidden_size ** 0.5
            for w in mod.parameters():
                w.copy_(torch.empty(w.shape).uniform_(-k, k, generator=gen))
            continue
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
            continue
        else:
            continue
        if mod.bias is not None:
            mod.bias.zero_()
    return model
