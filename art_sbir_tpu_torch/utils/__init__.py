"""Convenience re-exports of the port's most used helpers (the
counterpart of ``art_sbir_tpu/utils/__init__.py``, itself the
reference's grab-bag `utils.py` re-homed into layers: losses -> train/,
persistence -> core/ + retrieval/, distances -> ops/). The port saves
and loads torch state dicts (``save_state_dict``/``load_state_dict``)
where the JAX package saves and loads orbax pytrees."""

from art_sbir_tpu_torch.core.checkpoint import (CheckpointManager,
                                                load_state_dict,
                                                save_state_dict)
from art_sbir_tpu_torch.core.metrics import LossTracker, Timer
from art_sbir_tpu_torch.core.results import ResultsWriter, load_results
from art_sbir_tpu_torch.ops.distance import cosine_distance, euclidean_distance
from art_sbir_tpu_torch.retrieval.embed import (load_image_features,
                                                save_image_features)
from art_sbir_tpu_torch.train.losses import MARGIN, TripletLossConfig

__all__ = [
    "CheckpointManager", "save_state_dict", "load_state_dict",
    "LossTracker", "Timer", "ResultsWriter", "load_results",
    "cosine_distance", "euclidean_distance",
    "save_image_features", "load_image_features",
    "MARGIN", "TripletLossConfig",
]
