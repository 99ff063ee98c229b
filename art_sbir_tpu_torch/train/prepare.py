"""Device-side batch finishing: uint8 batches -> CLIP-normalized float,
and, for training, the paired flip and the sketch augmentation.

Counterpart of ``art_sbir_tpu/train/prepare.py``. The reference does this
per sample in DataLoader workers (PIL transforms, `transformations.py`);
here the loader ships uint8 and the device does /255, the CLIP normalize
and (train only) the Augmented datasets' paired flip and sketch
augmentation (`data_preparation.py:644-657`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from art_sbir_tpu_torch.ops.augment import paired_hflip, sketch_augment
from art_sbir_tpu_torch.ops.resize import CLIP_MEAN, CLIP_STD, normalize


def finish_triplet_batch(batch: Dict[str, torch.Tensor],
                         gen: Optional[torch.Generator] = None,
                         augment_version: int = 0, flip: bool = False,
                         train: bool = True,
                         rows: Optional[Tuple[int, int]] = None
                         ) -> Dict[str, torch.Tensor]:
    """uint8 triplet batch -> normalized float32 batch (other keys kept).

    ``augment_version`` > 0 runs ``sketch_augment`` V1/V2 on the sketch;
    ``flip`` applies the Augmented datasets' paired horizontal flip. Both
    need ``train`` and a ``gen`` on the batch's device. A per-sample
    ``augment`` mask (the Mixed catalogs augment only their
    Kaggle-sourced samples, reference `data_preparation.py:748-753`)
    keeps the other samples plain. ``rows`` = (offset, total): the batch
    is a data-parallel rank's rows of a global batch of ``total``, and
    the random draws are the global batch's (``ops/augment.py``)."""
    out = dict(batch)
    f = {k: batch[k].float() / 255.0
         for k in ("sketch", "positive", "negative") if k in batch}
    mask = batch.get("augment")
    sel = None if mask is None else (mask > 0)[:, None, None, None]

    if train and flip and gen is not None:
        fs, fp, fn = paired_hflip(gen, f["sketch"], f["positive"],
                                  f["negative"], rows=rows)
        if sel is not None:
            fs = torch.where(sel, fs, f["sketch"])
            fp = torch.where(sel, fp, f["positive"])
            fn = torch.where(sel, fn, f["negative"])
        f["sketch"], f["positive"], f["negative"] = fs, fp, fn
    if train and augment_version and gen is not None:
        augmented = sketch_augment(f["sketch"], gen, version=augment_version,
                                   do_normalize=True, rows=rows)
        if sel is not None:
            augmented = torch.where(sel, augmented,
                                    normalize(f["sketch"], CLIP_MEAN,
                                              CLIP_STD))
        f["sketch"] = augmented
        for k in ("positive", "negative"):
            f[k] = normalize(f[k], CLIP_MEAN, CLIP_STD)
    else:
        for k in f:
            f[k] = normalize(f[k], CLIP_MEAN, CLIP_STD)
    out.update(f)
    return out


def finish_gallery_batch(images_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, S, S, 3) -> CLIP-normalized float32 (B, S, S, 3)."""
    return normalize(images_uint8.float() / 255.0, CLIP_MEAN, CLIP_STD)
