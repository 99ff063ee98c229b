"""AdaIN style-transfer networks (PyTorch, NCHW).

Counterpart of ``art_sbir_tpu/models/adain_net.py`` (reference
`artwork_gen_utils/net.py:6-152`, `artwork_gen.py:29-44`): a VGG19
encoder through relu4_1 with reflection padding, a mirrored decoder with
nearest 2x upsampling, :func:`style_transfer` (content features
re-normalized to the style's statistics at relu4_1, then decoded) and the
training-time content and style losses as a function.

Both networks are the reference's ``nn.Sequential`` with its indices, so
the published checkpoints load with ``load_state_dict``: the encoder's
convs sit at 0 (the 1x1 colour projection), 2, 5, 9, 12, 16, 19, 22, 25
and 29 of ``vgg_normalised.pth``, the decoder's at 1, 5, 8, 11, 14, 18,
21, 25 and 28 of ``decoder.pth`` (the maps of JAX ``torch_port.py:155-174``).
``vgg_normalised.pth`` runs on to relu5_4; the loader drops the keys past
relu4_1 (:func:`art_sbir_tpu_torch.models.port_weights.load_adain_pth`).

The max pools floor (``ceil_mode=False``) as the JAX package's
``nn.max_pool`` does (``adain_net.py:47``); the reference's pools take
``ceil_mode=True``, which differs on odd feature sizes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from art_sbir_tpu_torch.ops.adain import (adaptive_instance_normalization,
                                          calc_mean_std)

# (features, maxpool before) of the encoder's 3x3 convs through relu4_1
_ENC_PLAN: Sequence[Tuple[int, bool]] = (
    (64, False), (64, False),                                # relu1_1, 1_2
    (128, True), (128, False),                               # relu2_1, 2_2
    (256, True), (256, False), (256, False), (256, False),   # relu3_x
    (512, True),                                             # relu4_1
)
# (features, nearest 2x upsample after) of the decoder's 3x3 convs
_DEC_PLAN: Sequence[Tuple[int, bool]] = (
    (256, True), (256, False), (256, False), (256, False),
    (128, True), (128, False), (64, True), (64, False),
)


class AdaINEncoder(nn.Sequential):
    """The 1x1 colour projection and VGG19's convs through relu4_1
    (Sequential indices 0..30 of the reference ``vgg``). ``capture=True``
    returns the relu1_1, relu2_1, relu3_1 and relu4_1 activations
    (indices 3, 10, 17, 30) for the style losses."""

    CAPTURE = (3, 10, 17, 30)

    def __init__(self):
        layers: List[nn.Module] = [nn.Conv2d(3, 3, 1)]
        cin = 3
        for feats, pool in _ENC_PLAN:
            if pool:
                layers.append(nn.MaxPool2d(2, 2))
            layers += [nn.ReflectionPad2d(1), nn.Conv2d(cin, feats, 3),
                       nn.ReLU()]
            cin = feats
        super().__init__(*layers)

    def forward(self, x: torch.Tensor, capture: bool = False):
        captured = []
        for i, layer in enumerate(self):
            x = layer(x)
            if i in self.CAPTURE:
                captured.append(x)
        return captured if capture else x


class AdaINDecoder(nn.Sequential):
    """Mirror of the encoder: reflect-padded 3x3 convs and nearest 2x
    upsamples (reference `net.py:6-37`). ``F.interpolate(scale_factor=2,
    mode='nearest')`` repeats each pixel twice, as JAX's
    ``jax.image.resize(..., 'nearest')`` at an exact 2x does, on odd sizes
    too."""

    def __init__(self):
        layers: List[nn.Module] = []
        cin = 512
        for feats, upsample in _DEC_PLAN:
            layers += [nn.ReflectionPad2d(1), nn.Conv2d(cin, feats, 3),
                       nn.ReLU()]
            if upsample:
                layers.append(nn.Upsample(scale_factor=2, mode="nearest"))
            cin = feats
        layers += [nn.ReflectionPad2d(1), nn.Conv2d(cin, 3, 3)]
        super().__init__(*layers)


def style_transfer(encoder: nn.Module, decoder: nn.Module,
                   content: torch.Tensor, style: torch.Tensor,
                   alpha: float = 1.0) -> torch.Tensor:
    """AdaIN inference (reference `artwork_gen.py:29-44`): NCHW content and
    style images in [0, 1] -> the stylized images (not clipped)."""
    content_feat = encoder(content)
    style_feat = encoder(style)
    t = adaptive_instance_normalization(content_feat, style_feat)
    t = alpha * t + (1.0 - alpha) * content_feat
    return decoder(t)


def adain_losses(encoder: AdaINEncoder, decoder: nn.Module,
                 content: torch.Tensor, style: torch.Tensor,
                 alpha: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(content loss, style loss) of the reference ``Net.forward``
    (`net.py:139-152`): the MSE at relu4_1 against the AdaIN target, and
    the MSEs of the means and stds at each relu*_1."""
    style_feats = encoder(style, capture=True)
    content_feat = encoder(content, capture=True)[-1]
    t = adaptive_instance_normalization(content_feat, style_feats[-1])
    t = alpha * t + (1.0 - alpha) * content_feat
    g_feats = encoder(decoder(t), capture=True)

    loss_c = torch.mean(torch.square(g_feats[-1] - t))
    loss_s = torch.zeros((), dtype=t.dtype, device=t.device)
    for gf, sf in zip(g_feats, style_feats):
        gm, gs = calc_mean_std(gf)
        sm, ss = calc_mean_std(sf)
        loss_s = loss_s + torch.mean(torch.square(gm - sm)) \
            + torch.mean(torch.square(gs - ss))
    return loss_c, loss_s
