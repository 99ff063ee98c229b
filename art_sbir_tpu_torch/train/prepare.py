"""Device-side batch finishing: uint8 batches -> CLIP-normalized float.

Counterpart of ``art_sbir_tpu/train/prepare.py`` (the gallery form; the
triplet form with its augmentations comes with the training slice)."""

from __future__ import annotations

import torch

from art_sbir_tpu_torch.ops.resize import CLIP_MEAN, CLIP_STD, normalize


def finish_gallery_batch(images_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, S, S, 3) -> CLIP-normalized float32 (B, S, S, 3)."""
    return normalize(images_uint8.float() / 255.0, CLIP_MEAN, CLIP_STD)
