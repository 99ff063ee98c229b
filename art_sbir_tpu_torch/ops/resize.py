"""CLIP and ImageNet normalization and torchvision resize/crop geometry.

Counterpart of ``art_sbir_tpu/ops/resize.py`` (the parts serving needs;
the matmul bicubic resize comes with the training slice)."""

from __future__ import annotations

from typing import Tuple

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)  # reference models.py:294
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)  # reference utils.py:124
IMAGENET_STD = (0.229, 0.224, 0.225)


def shortest_side_size(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision Resize(int) semantics: shortest side -> size, other side
    scaled with int() truncation."""
    if h <= w:
        return size, int(size * w / h)
    return int(size * h / w), size


def center_crop_slices(h: int, w: int, crop: int) -> Tuple[int, int]:
    """torchvision CenterCrop offsets (round, matching F.center_crop)."""
    top = int(round((h - crop) / 2.0))
    left = int(round((w - crop) / 2.0))
    return top, left


def normalize(img: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """(..., C) channel-last normalize; input in [0, 1]."""
    m = torch.tensor(mean, dtype=img.dtype, device=img.device)
    s = torch.tensor(std, dtype=img.dtype, device=img.device)
    return (img - m) / s
