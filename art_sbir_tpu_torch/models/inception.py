"""Inception v3 multi-feature classifier (PyTorch, NCHW).

Counterpart of ``art_sbir_tpu/models/inception.py`` (reference
`drawing_utils/model.py:174-279`, which wraps torchvision's inception_v3
with replaced fc and aux heads and can return intermediate features).
The graph is torchvision's v3 and so are the state-dict keys
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_6b.branch7x7_2.bn.running_var``,
``AuxLogits.fc.weight``, ...): :class:`BasicConv2d` is a bias-free conv,
BatchNorm (eps 1e-3; the port's flax-style
:class:`~art_sbir_tpu_torch.models.resnet.BatchNorm2d`, whose train mode
updates the running statistics with the biased batch variance) and a
ReLU; InceptionA to E; the aux head on Mixed_6e in train mode.
``every_feat`` returns the JAX package's (logits, features) pair: the
features are the map after the second InceptionC block (torchvision's
``Mixed_6c``; JAX names it ``feat21`` and calls it Mixed_6b), (B, 768,
17, 17) at 299 px. Pools count padding as torchvision's and flax's do.
Train mode's dropout takes its mask from ``dropout.generator`` (a
``torch.Generator``, as pix2pix's :class:`Dropout`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from art_sbir_tpu_torch.models import resnet
from art_sbir_tpu_torch.models.pix2pix import Dropout
from art_sbir_tpu_torch.models.resnet import BatchNorm2d, Conv2d


class BasicConv2d(nn.Module):
    """A bias-free conv, its BatchNorm (eval mode: on the conv's float32
    accumulator, :func:`~art_sbir_tpu_torch.models.resnet.conv_bn`) and a
    ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding)
        self.bn = BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(resnet.conv_bn(self.conv, self.bn, x))


def _pool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        db = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), db,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        db = x
        for i in range(1, 6):
            db = getattr(self, f"branch7x7dbl_{i}")(db)
        return torch.cat([self.branch1x1(x), b7, db,
                          self.branch_pool(_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        db = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        return torch.cat([self.branch1x1(x),
                          self.branch3x3_2a(b3), self.branch3x3_2b(b3),
                          self.branch3x3dbl_3a(db), self.branch3x3dbl_3b(db),
                          self.branch_pool(_pool3(x))], 1)


class InceptionAux(nn.Module):
    def __init__(self, cin: int, num_classes: int):
        super().__init__()
        self.conv0 = BasicConv2d(cin, 128, 1)
        self.conv1 = BasicConv2d(128, 768, 5)
        self.fc = nn.Linear(768, num_classes)

    def forward(self, x):
        x = self.conv1(self.conv0(F.avg_pool2d(x, 5, stride=3)))
        return self.fc(x.mean(dim=(2, 3)))


# the stem's BasicConv2ds: (name, in, out, kernel, stride, padding); a
# 3x3 stride-2 max pool follows the third and the fifth
STEM = (
    ("Conv2d_1a_3x3", 3, 32, 3, 2, 0),
    ("Conv2d_2a_3x3", 32, 32, 3, 1, 0),
    ("Conv2d_2b_3x3", 32, 64, 3, 1, 1),
    ("Conv2d_3b_1x1", 64, 80, 1, 1, 0),
    ("Conv2d_4a_3x3", 80, 192, 3, 1, 0),
)
# the Inception blocks: (name, block, its arguments), in the forward's order
MIXED = (
    ("Mixed_5b", InceptionA, (192, 32)), ("Mixed_5c", InceptionA, (256, 64)),
    ("Mixed_5d", InceptionA, (288, 64)), ("Mixed_6a", InceptionB, (288,)),
    ("Mixed_6b", InceptionC, (768, 128)), ("Mixed_6c", InceptionC, (768, 160)),
    ("Mixed_6d", InceptionC, (768, 160)), ("Mixed_6e", InceptionC, (768, 192)),
    ("Mixed_7a", InceptionD, (768,)), ("Mixed_7b", InceptionE, (1280,)),
    ("Mixed_7c", InceptionE, (2048,)),
)


class InceptionV3(nn.Module):
    """NCHW (B, 3, S, S) -> (logits, aux logits or None) or, with
    ``every_feat``, (logits, the features after ``Mixed_6c``) (reference
    `model.py:250-279`, JAX ``inception.py:142-172``). The aux head
    exists where JAX's train-mode init makes it (``use_aux`` and not
    ``every_feat``) and runs in train mode only."""

    def __init__(self, num_classes: int = 1000, use_aux: bool = True,
                 every_feat: bool = False, dropout_rate: float = 0.5):
        super().__init__()
        self.every_feat = every_feat
        for name, cin, cout, k, s, p in STEM:
            setattr(self, name, BasicConv2d(cin, cout, k, stride=s,
                                            padding=p))
        for name, block, args in MIXED:
            setattr(self, name, block(*args))
        self.AuxLogits = (InceptionAux(768, num_classes)
                          if use_aux and not every_feat else None)
        self.dropout = Dropout(dropout_rate)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        for i, (name, *_) in enumerate(STEM):
            x = getattr(self, name)(x)
            if i in (2, 4):
                x = F.max_pool2d(x, 3, stride=2)
        feat, aux = None, None
        with_aux = self.training and self.AuxLogits is not None
        for name, *_ in MIXED:
            if name == "Mixed_7a" and with_aux:  # on Mixed_6e's output
                aux = self.AuxLogits(x)
            x = getattr(self, name)(x)
            if name == "Mixed_6c":  # JAX's feat21
                feat = x
        logits = self.fc(self.dropout(x.mean(dim=(2, 3))))
        return (logits, feat) if self.every_feat else (logits, aux)


def create_inception(num_classes: int = 1000, use_aux: bool = True,
                     every_feat: bool = False, dropout_rate: float = 0.5,
                     seed: int = 0) -> InceptionV3:
    """JAX's fresh init under ``jax.random.key(seed)`` (flax's
    ``lecun_normal`` convs and dense kernels, zero biases, identity
    BatchNorm; ``AuxLogits`` as a train-mode init makes it), drawn on the
    host without JAX (:mod:`~art_sbir_tpu_torch.models.flax_families`),
    on the CPU."""
    from art_sbir_tpu_torch.models import flax_families

    model = InceptionV3(num_classes, use_aux, every_feat, dropout_rate)
    model.load_state_dict(flax_families.inception_v3(
        seed, num_classes, model.AuxLogits is not None))
    return model
