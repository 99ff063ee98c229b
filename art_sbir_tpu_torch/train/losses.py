"""Triplet-margin losses with optional classification heads.

Counterpart of ``art_sbir_tpu/train/losses.py`` (reference
`utils.py:31-77`, `train.py:164-175`):

* euclidean: ``torch.nn.TripletMarginLoss``, pairwise L2 with the 1e-6
  epsilon folded into the difference;
* cosine: ``TripletMarginWithDistanceLoss(distance_function=1-cos)``;
* ``_with_classification``: + w * (CE(sketch_cls) + CE(pos_cls)), default
  w = 0.5 (`utils.py:49-60`);
* ``_with_classification2``: two heads (styles and genres), weights
  (w1, w2), default (0.25, 0.5) (`utils.py:62-75`).

Default margin 0.2 (`utils.py:77`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from art_sbir_tpu_torch.ops.distance import cosine_distance, euclidean_distance

MARGIN = 0.2  # "Sketching without Worrying" default, reference utils.py:77


def _distance_fn(loss_type: str) -> Callable:
    if loss_type == "euclidean":
        return euclidean_distance
    if loss_type == "cosine":
        return cosine_distance
    raise ValueError(f"loss type not correct {loss_type}")


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = MARGIN,
                        loss_type: str = "euclidean") -> torch.Tensor:
    d = _distance_fn(loss_type)
    return torch.clamp(d(anchor, positive) - d(anchor, negative) + margin,
                       min=0.0).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long())


@dataclasses.dataclass(frozen=True)
class TripletLossConfig:
    """One config covering all four reference loss variants."""

    margin: float = MARGIN
    loss_type: str = "euclidean"  # euclidean | cosine
    classification_weight: float = 0.0  # w for head 1 (0 = no head-1 loss)
    classification_weight2: float = 0.0  # w2 for head 2
    num_heads: int = 0  # 0, 1, or 2 classifier heads present on the model

    @staticmethod
    def for_dataset(dataset: str, loss_type: str, with_classification: bool,
                    margin: float = MARGIN) -> "TripletLossConfig":
        """The dataset-family dispatch of reference `train.py:164-175`."""
        if not with_classification:
            return TripletLossConfig(margin=margin, loss_type=loss_type)
        if "Sketchy" in dataset:
            return TripletLossConfig(margin, loss_type, 0.5, 0.0, num_heads=1)
        if "Mixed" in dataset:
            w = 0.01 if loss_type == "euclidean" else 0.5
            return TripletLossConfig(margin, loss_type, w, 0.0, num_heads=1)
        if "Kaggle" in dataset:
            if loss_type == "euclidean":
                return TripletLossConfig(margin, loss_type, 0.0, 0.2,
                                         num_heads=2)
            return TripletLossConfig(margin, loss_type, 0.25, 0.5, num_heads=2)
        return TripletLossConfig(margin=margin, loss_type=loss_type)


def triplet_loss_with_heads(cfg: TripletLossConfig, s_out, p_out, n_out,
                            labels: Optional[torch.Tensor] = None,
                            labels2: Optional[torch.Tensor] = None
                            ) -> Dict[str, torch.Tensor]:
    """Combined loss. ``*_out`` are embeddings, or (embedding, logits,
    [logits2]) tuples from the classification model."""
    if cfg.num_heads == 0:
        trip = triplet_margin_loss(s_out, p_out, n_out, cfg.margin,
                                   cfg.loss_type)
        return {"loss": trip, "triplet": trip}

    trip = triplet_margin_loss(s_out[0], p_out[0], n_out[0], cfg.margin,
                               cfg.loss_type)
    cls1 = cross_entropy(s_out[1], labels) + cross_entropy(p_out[1], labels)
    total = trip + cfg.classification_weight * cls1
    out = {"triplet": trip, "classification": cls1}
    if cfg.num_heads == 2:
        cls2 = (cross_entropy(s_out[2], labels2)
                + cross_entropy(p_out[2], labels2))
        total = total + cfg.classification_weight2 * cls2
        out["classification2"] = cls2
    out["loss"] = total
    return out
