"""Informative-drawings line-drawing generator (PyTorch, NCHW).

Counterpart of ``art_sbir_tpu/models/drawing.py`` (reference
`drawing_utils/model.py:31-86` and `:130-171`).

* :class:`DrawingGenerator`: a reflect-padded 7x7 stem, two stride-2
  downs, ``n_residual_blocks`` residual blocks (3 in the shipped
  checkpoints), two transposed-conv ups and a reflect-padded 7x7 head
  with a sigmoid; one output channel; every norm an instance norm with
  torch's defaults (float32 statistics, :func:`instance_norm`). The two
  downs zero-pad (``padding=1``): only the stem, the residual convs and
  the head reflect-pad (JAX ``drawing.py:44-46``).
* :class:`GlobalGenerator2`: the pix2pixHD-style generator of the same
  utilities, which no entry point calls; eval-mode BatchNorm only. Each
  conv or transposed conv before a BatchNorm hands it its float32
  accumulator in eval mode (``resnet.py::conv_bn``).

Both keep the reference's ``nn.Sequential`` indices, so the published
``{contour, anime, opensketch}.pth`` load with ``load_state_dict``:
``model0.1``, ``model1.{0,3}``, ``model2.{i}.conv_block.{1,5}``,
``model3.{0,3}`` and ``model4.1`` (the map of JAX ``torch_port.py:118-138``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from art_sbir_tpu_torch.models.layers import InstanceNorm
from art_sbir_tpu_torch.models.pix2pix import ConvTranspose2d
from art_sbir_tpu_torch.models.resnet import BatchNorm2d, Conv2d, Sequential


class _ResBlock(nn.Module):
    """``x + IN(conv(pad(relu(IN(conv(pad(x)))))))``, keys
    ``conv_block.{1,5}``."""

    def __init__(self, features: int,
                 norm: Callable[[int], nn.Module] = lambda c: InstanceNorm()):
        super().__init__()
        self.conv_block = Sequential(
            nn.ReflectionPad2d(1),
            Conv2d(features, features, 3, padding=0, bias=True),
            norm(features), nn.ReLU(),
            nn.ReflectionPad2d(1),
            Conv2d(features, features, 3, padding=0, bias=True),
            norm(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class DrawingGenerator(nn.Module):
    """NCHW images in [0, 1] -> (N, output_nc, H, W) drawings. The input's
    dtype is the compute dtype (``model.to(torch.bfloat16)`` with a bf16
    input runs the convolutions in bf16; the norms' statistics stay
    float32)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 1,
                 n_residual_blocks: int = 3, use_sigmoid: bool = True):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        self.model0 = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(input_nc, 64, 7), InstanceNorm(),
            nn.ReLU())
        self.model1 = nn.Sequential(
            nn.Conv2d(64, 128, 3, stride=2, padding=1), InstanceNorm(),
            nn.ReLU(),
            nn.Conv2d(128, 256, 3, stride=2, padding=1), InstanceNorm(),
            nn.ReLU())
        self.model2 = nn.Sequential(
            *[_ResBlock(256) for _ in range(n_residual_blocks)])
        self.model3 = nn.Sequential(
            nn.ConvTranspose2d(256, 128, 3, stride=2, padding=1,
                               output_padding=1), InstanceNorm(), nn.ReLU(),
            nn.ConvTranspose2d(128, 64, 3, stride=2, padding=1,
                               output_padding=1), InstanceNorm(), nn.ReLU())
        self.model4 = nn.Sequential(nn.ReflectionPad2d(3),
                                    nn.Conv2d(64, output_nc, 7))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.model4(self.model3(self.model2(self.model1(self.model0(x)))))
        return torch.sigmoid(h) if self.use_sigmoid else h


class GlobalGenerator2(nn.Module):
    """pix2pixHD-style generator (reference `drawing_utils/model.py:130-171`,
    JAX ``drawing.py:65-108``), keys ``model.{i}`` of the reference's one
    Sequential. It keeps the reference's quirk of 'downsampling' with
    stride-2 transposed convs from ``ngf * 8`` channels. BatchNorm is the
    port's flax-style :class:`BatchNorm2d`; the JAX package holds this
    model in eval mode only, and so does its test here."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 3, n_blocks: int = 9,
                 n_upsampling: int = 0, use_sig: bool = False):
        super().__init__()
        mult = 8
        layers = [nn.ReflectionPad2d(4),
                  Conv2d(input_nc, ngf * mult, 7, padding=0, bias=True),
                  BatchNorm2d(ngf * mult), nn.ReLU()]
        for _ in range(n_downsampling):
            layers += [ConvTranspose2d(ngf * mult, ngf * mult // 2, 4,
                                       stride=2, padding=1),
                       BatchNorm2d(ngf * mult // 2), nn.ReLU()]
            mult //= 2
        layers += [_ResBlock(ngf * mult, norm=BatchNorm2d)
                   for _ in range(n_blocks)]
        for _ in range(n_upsampling if n_upsampling > 0 else n_downsampling):
            nxt = mult // 2 or 1
            layers += [ConvTranspose2d(ngf * mult, ngf * nxt, 3, stride=2,
                                       padding=1, output_padding=1),
                       BatchNorm2d(ngf * nxt), nn.ReLU()]
            mult = nxt
        layers += [nn.ReflectionPad2d(3),
                   Conv2d(ngf * mult, output_nc, 7, padding=0, bias=True),
                   nn.Sigmoid() if use_sig else nn.Tanh()]
        self.model = Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)
