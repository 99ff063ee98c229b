"""Style-transfer odds and ends of the reference's drawing utilities:
gram matrices and ImageNet batch normalization (reference
`drawing_utils/utils_pl.py:6-23`), and the CycleGAN-style replay buffer
(reference `drawing_utils/utils.py:11-45`), host-side state feeding
device steps.

Counterpart of ``art_sbir_tpu/ops/style_misc.py``, in the port's NCHW.
"""

from __future__ import annotations

import random
from typing import List

import torch

from art_sbir_tpu_torch.ops.resize import IMAGENET_MEAN, IMAGENET_STD


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, C) / (C*H*W) (reference `utils_pl.py:6-12`)."""
    b, c, h, w = feat.shape
    x = feat.reshape(b, c, h * w)
    return torch.bmm(x, x.transpose(1, 2)) / (c * h * w)


def normalize_batch(batch01: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize a [0, 1] NCHW batch (reference
    `utils_pl.py:15-23`)."""
    kw = dict(dtype=batch01.dtype, device=batch01.device)
    mean = torch.tensor(IMAGENET_MEAN, **kw)[:, None, None]
    std = torch.tensor(IMAGENET_STD, **kw)[:, None, None]
    return (batch01 - mean) / std


class ReplayBuffer:
    """50-image history buffer for discriminator inputs (reference
    `drawing_utils/utils.py:11-45`): each incoming image is stored while
    the buffer fills; afterwards, with p=0.5 a random stored image is
    returned (and replaced), else the incoming one. The draws come from
    ``random.Random(seed)``, as in the JAX package, so the same inputs
    give the same sequence there and here."""

    def __init__(self, max_size: int = 50, seed: int = 0):
        assert max_size > 0
        self.max_size = max_size
        self.data: List[torch.Tensor] = []
        self.rng = random.Random(seed)

    def push_and_pop(self, batch: torch.Tensor) -> torch.Tensor:
        out = []
        for element in batch.detach():
            if len(self.data) < self.max_size:
                self.data.append(element.clone())
                out.append(element)
            elif self.rng.uniform(0, 1) > 0.5:
                i = self.rng.randint(0, self.max_size - 1)
                out.append(self.data[i].clone())
                self.data[i] = element.clone()
            else:
                out.append(element)
        return torch.stack(out)
