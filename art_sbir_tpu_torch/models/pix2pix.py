"""pix2pix generators, discriminators and GAN objectives (PyTorch, NCHW).

Counterpart of ``art_sbir_tpu/models/pix2pix.py`` (reference
`pix2pix_model.py:388-880`): :class:`ResnetGenerator` (reflect-padded 7x7
stem, two stride-2 downs, ``n_blocks`` residual blocks, two transposed-conv
ups, tanh), :class:`UnetGenerator` (recursive 4x4 stride-2 skip blocks),
the 70x70 PatchGAN (:class:`NLayerDiscriminator`) and the 1x1 PixelGAN
(:class:`PixelDiscriminator`).

* Norms: ``batch`` is the port's flax-style
  :class:`~art_sbir_tpu_torch.models.resnet.BatchNorm2d` (momentum
  ``BN_MOMENTUM``, eps 1e-5, the biased running variance), ``instance`` is
  :func:`~art_sbir_tpu_torch.models.layers.instance_norm` without affine,
  ``none`` an identity. A conv followed by a batch norm has no bias.
* State-dict keys are the reference's, so its ``latest_net_G.pth`` and
  ``latest_net_D.pth`` load natively: the ResNet and the PatchGAN are one
  ``model.*`` Sequential (a residual block's convs at ``conv_block.1`` and
  ``.6``: index 4 is the dropout slot, an identity without dropout), the
  U-Net nests ``model.model.<i>.model...``, the PixelGAN is ``net.*``.
  JAX ``torch_port.py::port_resnet_generator``,
  ``port_unet_generator`` and ``port_patchgan_discriminator`` map the
  same keys.
* ``dtype`` is the compute dtype (bf16 for ``--bf16``): the input is cast
  to it and each conv casts its float32 weights to the input's dtype;
  the norms take their statistics in float32. The output comes back in
  float32 (float64 in a float64 model), as JAX's ``_apply`` casts it.
* The skip of a U-Net block is ``cat([x, h])`` of its own input, as the
  JAX package computes it (ROADMAP.md §3 notes the reference's in-place
  LeakyReLU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from art_sbir_tpu_torch.core.device import native_ieee_f32
from art_sbir_tpu_torch.models.layers import InstanceNorm
from art_sbir_tpu_torch.models.resnet import (BatchNorm2d, Conv2d, Sequential,
                                             float32_accumulator)
from art_sbir_tpu_torch.parallel.tensor import whole

class ConvTranspose2d(nn.ConvTranspose2d):
    """A transposed conv whose float32 weight and bias are cast to the
    input's dtype; torch's own geometry, ``(in-1)*s - 2p + k + op``.

    Under tensor parallelism (``parallel/tensor.py``: ``tp``, ``tp_dims``)
    the weight holds this rank's INPUT channels where they divide (JAX's
    kernel is ``(kh, kw, out, in)``): the rank's slice of the input goes
    through them and the partial outputs are summed over the model group;
    the bias, sharded on the output channels, is gathered and added
    once.

    ``to_bn``: the conv feeds a BatchNorm (``resnet.py::conv_bn``); in
    eval mode a bf16 input then gives the float32 accumulator, as the
    encoder's :class:`~art_sbir_tpu_torch.models.resnet.Conv2d` does
    (jitted XLA fuses a flax transposed conv and its BN as it fuses a
    conv and its BN). An IEEE float32 one on the card runs without cuDNN
    (``core/device.py::native_ieee_f32``)."""

    def _apply_to(self, x: torch.Tensor, weight: torch.Tensor,
                  bias, dtype: torch.dtype) -> torch.Tensor:
        """The transposed conv of ``x``, its operands rounded to ``x``'s
        dtype, computed in ``dtype``."""
        return F.conv_transpose2d(
            x.to(dtype), weight.to(x.dtype).to(dtype),
            None if bias is None else bias.to(x.dtype).to(dtype),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)

    def forward(self, x: torch.Tensor, to_bn: bool = False) -> torch.Tensor:
        acc = torch.promote_types(x.dtype, torch.float32)
        if not to_bn or self.training or acc == x.dtype:
            with native_ieee_f32(x):
                return self._forward(x, x.dtype)
        with float32_accumulator():
            return self._forward(x, acc)

    def _forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        tp = getattr(self, "tp", None)
        (bias,) = whole(self, "bias")
        if tp is None or "weight" not in self.tp_dims:
            return self._apply_to(x, self.weight, bias, dtype)
        y = tp.reduce(self._apply_to(tp.scatter(x, 1), self.weight, None,
                                     dtype))
        return y if bias is None else y + bias.to(x.dtype).to(y.dtype)[
            None, :, None, None]


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode each element is kept with
    probability ``1 - p`` and a kept one is scaled by ``1 / (1 - p)``. The
    mask comes from ``generator`` (a ``torch.Generator`` on the input's
    device, set by the trainer each step) or, without one, from torch's
    global stream. ``rows`` = (offset, total) makes the input a
    data-parallel rank's rows of a global batch of ``total``: the mask is
    drawn for the global batch and the rank keeps its rows, so every rank
    drops what one device would."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None
        self.rows: Optional[Tuple[int, int]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        keep = 1.0 - self.p
        shape, off = x.shape, 0
        if self.rows is not None:
            off, total = self.rows
            shape = (total,) + tuple(x.shape[1:])
        mask = torch.rand(shape, generator=self.generator,
                          device=x.device)[off:off + x.shape[0]] < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def norm_layer(kind: str, channels: int) -> nn.Module:
    """batch | instance | none; none of them holds a key but batch."""
    if kind == "batch":
        return BatchNorm2d(channels)
    if kind == "instance":
        return InstanceNorm()
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind}")


def _use_bias(norm: str) -> bool:
    # a batch norm's affine shift makes a conv bias redundant (reference
    # pix2pix_model.py:612-616)
    return norm in ("instance", "none")


class _Net(nn.Module):
    """Casts the input to ``dtype`` (when set) and the output back to at
    least float32. ``geometry``: the net's constructor arguments but the
    dtype (its fresh init is drawn from them,
    ``models/flax_families.py::pix2pix``)."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype

    def body(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.body(x if self.dtype is None else x.to(self.dtype))
        return out.to(torch.promote_types(out.dtype, torch.float32))


class ResnetBlock(nn.Module):
    """``x + norm(conv(pad(dropout(relu(norm(conv(pad(x))))))))``."""

    def __init__(self, dim: int, norm: str = "batch",
                 use_dropout: bool = False):
        super().__init__()
        ub = _use_bias(norm)
        self.conv_block = Sequential(
            nn.ReflectionPad2d(1), Conv2d(dim, dim, 3, padding=0, bias=ub),
            norm_layer(norm, dim), nn.ReLU(),
            Dropout(0.5) if use_dropout else nn.Identity(),
            nn.ReflectionPad2d(1), Conv2d(dim, dim, 3, padding=0, bias=ub),
            norm_layer(norm, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class ResnetGenerator(_Net):
    def __init__(self, input_nc: int = 3, output_nc: int = 1, ngf: int = 64,
                 n_blocks: int = 9, norm: str = "batch",
                 use_dropout: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dtype)
        self.geometry = dict(input_nc=input_nc, output_nc=output_nc,
                             ngf=ngf, norm=norm, n_blocks=n_blocks)
        ub = _use_bias(norm)
        layers = [nn.ReflectionPad2d(3),
                  Conv2d(input_nc, ngf, 7, padding=0, bias=ub),
                  norm_layer(norm, ngf), nn.ReLU()]
        for i in range(2):  # downsampling
            c = ngf * 2 ** i
            layers += [Conv2d(c, c * 2, 3, stride=2, padding=1, bias=ub),
                       norm_layer(norm, c * 2), nn.ReLU()]
        layers += [ResnetBlock(ngf * 4, norm, use_dropout)
                   for _ in range(n_blocks)]
        for i in range(2):  # upsampling
            c = ngf * 2 ** (2 - i)
            layers += [ConvTranspose2d(c, c // 2, 3, stride=2, padding=1,
                                       output_padding=1, bias=ub),
                       norm_layer(norm, c // 2), nn.ReLU()]
        layers += [nn.ReflectionPad2d(3),
                   Conv2d(ngf, output_nc, 7, padding=0, bias=True),
                   nn.Tanh()]
        self.model = Sequential(*layers)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class UnetSkipBlock(nn.Module):
    """One level of the U-Net (reference ``UnetSkipConnectionBlock``).
    ``model`` keeps the reference's indices: outermost ``[down, sub, relu,
    up, tanh]``; innermost ``[leaky, down, relu, up, upnorm]``; middle
    ``[leaky, down, downnorm, sub, relu, up, upnorm(, dropout)]``. The
    downconv's bias follows the norm rule even in the outermost block; the
    upconv has one only without batch norm or in the outermost block."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None,
                 outermost: bool = False, innermost: bool = False,
                 norm: str = "batch", use_dropout: bool = False):
        super().__init__()
        self.outermost = outermost
        ub = _use_bias(norm)
        down = Conv2d(input_nc or outer_nc, inner_nc, 4, stride=2, padding=1,
                      bias=ub)
        up_in = inner_nc if innermost else inner_nc * 2
        up = ConvTranspose2d(up_in, outer_nc, 4, stride=2, padding=1,
                             bias=ub or outermost)
        if outermost:
            layers = [down, submodule, nn.ReLU(), up, nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(), up,
                      norm_layer(norm, outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), down, norm_layer(norm, inner_nc),
                      submodule, nn.ReLU(), up, norm_layer(norm, outer_nc)]
            if use_dropout:
                layers.append(Dropout(0.5))
        self.model = Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UnetGenerator(_Net):
    def __init__(self, input_nc: int = 3, output_nc: int = 1,
                 num_downs: int = 8, ngf: int = 64, norm: str = "batch",
                 use_dropout: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dtype)
        self.geometry = dict(input_nc=input_nc, output_nc=output_nc,
                             ngf=ngf, norm=norm, num_downs=num_downs)
        block = UnetSkipBlock(ngf * 8, ngf * 8, innermost=True, norm=norm)
        for _ in range(num_downs - 5):
            block = UnetSkipBlock(ngf * 8, ngf * 8, submodule=block,
                                  norm=norm, use_dropout=use_dropout)
        for mult in (4, 2, 1):
            block = UnetSkipBlock(ngf * mult, ngf * mult * 2,
                                  submodule=block, norm=norm)
        self.model = UnetSkipBlock(output_nc, ngf, input_nc=input_nc,
                                   submodule=block, outermost=True,
                                   norm=norm)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class NLayerDiscriminator(_Net):
    """70x70 PatchGAN at ``n_layers`` 3 (reference
    `pix2pix_model.py:803-859`): convs at ``model.{0, 2, 5, 8, 11}``, norms
    at ``model.{3, 6, 9}``; the fourth conv has stride 1."""

    def __init__(self, input_nc: int = 4, ndf: int = 64, n_layers: int = 3,
                 norm: str = "batch", dtype: Optional[torch.dtype] = None):
        super().__init__(dtype)
        self.geometry = dict(input_nc=input_nc, ndf=ndf, norm=norm,
                             n_layers=n_layers)
        ub = _use_bias(norm)
        layers = [Conv2d(input_nc, ndf, 4, stride=2, padding=1, bias=True),
                  nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers + 1):
            prev, nf = nf, min(2 ** n, 8)
            layers += [Conv2d(ndf * prev, ndf * nf, 4,
                              stride=2 if n < n_layers else 1, padding=1,
                              bias=ub),
                       norm_layer(norm, ndf * nf), nn.LeakyReLU(0.2)]
        layers.append(Conv2d(ndf * nf, 1, 4, padding=1, bias=True))
        self.model = Sequential(*layers)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class PixelDiscriminator(_Net):
    """1x1 PixelGAN (reference `pix2pix_model.py:862-880`), keys
    ``net.{0, 2, 3, 5}``."""

    def __init__(self, input_nc: int = 4, ndf: int = 64, norm: str = "batch",
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dtype)
        self.geometry = dict(input_nc=input_nc, ndf=ndf, norm=norm)
        ub = _use_bias(norm)
        self.net = Sequential(
            Conv2d(input_nc, ndf, 1, bias=True), nn.LeakyReLU(0.2),
            Conv2d(ndf, ndf * 2, 1, bias=ub), norm_layer(norm, ndf * 2),
            nn.LeakyReLU(0.2), Conv2d(ndf * 2, 1, 1, bias=ub))

    def body(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


def define_g(net_g: str, output_nc: int = 1, ngf: int = 64,
             norm: str = "batch", use_dropout: bool = False,
             dtype: Optional[torch.dtype] = None,
             input_nc: int = 3) -> nn.Module:
    """Generator factory (reference `pix2pix_model.py:443-494`)."""
    if net_g == "resnet_9blocks":
        return ResnetGenerator(input_nc, output_nc, ngf, 9, norm,
                               use_dropout, dtype)
    if net_g == "unet_256":
        return UnetGenerator(input_nc, output_nc, 8, ngf, norm, use_dropout,
                             dtype)
    raise NotImplementedError(
        f"Generator model name [{net_g}] is not recognized")


def define_d(net_d: str, ndf: int = 64, n_layers_d: int = 3,
             norm: str = "batch", dtype: Optional[torch.dtype] = None,
             input_nc: int = 4) -> nn.Module:
    """Discriminator factory (reference `pix2pix_model.py:497-527`);
    ``input_nc`` is the channels of ``cat([A, B])``."""
    if net_d == "basic":
        return NLayerDiscriminator(input_nc, ndf, 3, norm, dtype)
    if net_d == "n_layers":
        return NLayerDiscriminator(input_nc, ndf, n_layers_d, norm, dtype)
    if net_d == "pixel":
        return PixelDiscriminator(input_nc, ndf, norm, dtype)
    raise NotImplementedError(
        f"Discriminator model name [{net_d}] is not recognized")


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator],
                          rows: Optional[Tuple[int, int]] = None) -> None:
    """Point every :class:`Dropout` of ``model`` at ``generator`` and
    ``rows`` (see :class:`Dropout`)."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator
            mod.rows = rows


class GANLoss:
    """vanilla (the log-sigmoid form of BCE with logits) | lsgan (MSE) |
    wgangp (-mean for real, mean for fake; no gradient penalty) (reference
    `pix2pix_model.py:533-599`, JAX ``pix2pix.py:255-274``)."""

    def __init__(self, gan_mode: str = "vanilla"):
        if gan_mode not in ("vanilla", "lsgan", "wgangp"):
            raise NotImplementedError(f"gan mode {gan_mode} not implemented")
        self.gan_mode = gan_mode

    def __call__(self, prediction: torch.Tensor,
                 target_is_real: bool) -> torch.Tensor:
        t = 1.0 if target_is_real else 0.0
        if self.gan_mode == "vanilla":
            return -torch.mean(t * F.logsigmoid(prediction)
                               + (1.0 - t) * F.logsigmoid(-prediction))
        if self.gan_mode == "lsgan":
            return torch.mean(torch.square(prediction - t))
        return -prediction.mean() if target_is_real else prediction.mean()
