"""VGG16's convolutional features (PyTorch, NCHW): the Photo2Sketch image
encoder's backbone.

Counterpart of ``art_sbir_tpu/models/vgg.py`` (reference `models.py:35-49`,
torchvision ``vgg16().features``). :class:`VGGFeatures` is an
``nn.Sequential`` in torchvision's layout, so a ``features`` state dict
loads as it is: 3x3 convs (padding 1) at indices 0, 2, 5, 7, 10, 12, 14,
17, 19, 21, 24, 26 and 28, each followed by a ReLU, and 2x2 max pools
between the stages (the map of JAX ``torch_port.py::port_vgg16_features``).
A 256 px input gives an (512, 8, 8) map, the grid the decoder attends over.

``dtype=torch.bfloat16`` runs the convs in bf16 on float32 parameters (a
cast a call, :class:`~art_sbir_tpu_torch.models.resnet.Conv2d`): JAX's
``VGGFeatures(dtype=bfloat16)``, whose float32 parameters are cast to the
compute dtype; the output is bf16. Every conv is called as a module, so
tensor parallelism's column-parallel swap reaches each of them.

The weights and activations are channels-last (NHWC in memory, JAX's own
layout; the tensors stay NCHW in shape): cuDNN's kernels for it run the
VAE's train step faster than NCHW's in float32 and in bf16, and in NCHW
cuDNN takes the float32 weight gradients of the 3x3 convs by FFT, the
first convs' farthest from float64 (``scripts/probe_vgg_grad_layout.py``;
PERF.md §6).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from art_sbir_tpu_torch.models.resnet import Conv2d

# torchvision vgg16, configuration "D"
VGG16_CFG: Sequence = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                       512, 512, 512, "M", 512, 512, 512, "M")
CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


class VGGFeatures(nn.Sequential):
    def __init__(self, dtype: Optional[torch.dtype] = None):
        layers: List[nn.Module] = []
        cin = 3
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv2d(cin, v, 3, padding=1, bias=True), nn.ReLU()]
                cin = v
        super().__init__(*layers)
        self.dtype = dtype
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=torch.channels_last)
        return super().forward(x if self.dtype is None else x.to(self.dtype))
