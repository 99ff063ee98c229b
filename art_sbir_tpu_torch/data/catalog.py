"""Catalog base types and the dataset factory.

Counterpart of ``art_sbir_tpu/data/catalog.py``. A catalog is a cheap
table of paths/labels plus sampling rules — the counterpart of the
reference's torch Dataset classes (reference `data_preparation.py`) with
all tensor work moved out (host decode in
:mod:`art_sbir_tpu_torch.data.loader`, math on the device). The factory
:func:`get_datasets` keeps the reference's string surface
(`data_preparation.py:796-848`) through an explicit registry, not eval.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from art_sbir_tpu_torch.core.config import Registry
from art_sbir_tpu_torch.data.split import split_arrays


class RetrievalCatalog:
    """Triplet protocol: per index a (sketch, positive, negative) of paths.

    Mirrors the reference ``RetrievalDataset`` contract
    (`data_preparation.py:45-113`): ``sketch_paths``/``photo_paths`` aligned
    lists, uniform-random negatives (V1), seeded split, ``state_dict``
    metadata. Negative sampling uses stdlib ``random`` seeded like the
    reference (`data_preparation.py:52`).
    """

    name = "RetrievalCatalog"

    #: Host-decode geometry matching the transform the reference hands this
    #: dataset family. Plain catalogs receive ``model.transform`` =
    #: Resize(shortest side, bicubic) + CenterCrop (reference
    #: `models.py:289-295`, passed at `train.py:152` / `inference.py:148`);
    #: Augmented/Mixed families override it to square Resize((S, S))
    #: (`data_preparation.py:641,670,725`) and set ``"square"`` instead.
    resize_mode = "shortest_crop"

    def __init__(
        self,
        sketch_format="png",
        img_format="jpg",
        img_type="photos",
        mode="train",
        split_ratio=0.1,
        size=0.1,
        seed=42,
    ):
        self.rng = random.Random(seed)
        self.mode, self.split_ratio, self.size, self.seed = mode, split_ratio, size, seed
        self.sketch_format, self.img_format, self.img_type = (
            sketch_format, img_format, img_type,
        )
        self.sketch_paths: List[Path] = []
        self.photo_paths: List[Path] = []
        self.labels: Optional[List[int]] = None
        self.labels2: Optional[List[int]] = None

    def __len__(self) -> int:
        return len(self.sketch_paths)

    def _sample_split(self, lists):
        out = split_arrays(lists, self.split_ratio, 42, self.mode)
        return out

    # --- triplet protocol -------------------------------------------------

    def negative_index(self, idx: int) -> int:
        """V1 rule: uniform random photo (reference
        `data_preparation.py:67`)."""
        return self.rng.randrange(len(self.photo_paths))

    def item(self, idx: int) -> Dict:
        """Paths + labels for one triplet; the loader decodes."""
        out = {
            "sketch": self.sketch_paths[idx],
            "positive": self.photo_paths[idx],
            "negative": self.photo_paths[self.negative_index(idx)],
        }
        if self.labels is not None:
            out["label"] = self.labels[idx]
        if self.labels2 is not None:
            out["label2"] = self.labels2[idx]
        return out

    @property
    def state_dict(self) -> Dict:
        return {
            "dataset": self.name,
            "size": self.size,
            "img_number": len(self),
            "img_type": self.img_type,
            "img_format": self.img_format,
            "sketch_format": self.sketch_format,
            "seed": self.seed,
            "split_ratio": self.split_ratio,
            "mode": self.mode,
            "transform": f"host: {self.resize_mode} bicubic + device: CLIP normalize",
            "resize_mode": self.resize_mode,
        }


class InferenceCatalog:
    """Dedup-sorted gallery paths (reference `data_preparation.py:24-41`)."""

    def __init__(self, image_paths):
        self.image_paths = sorted(dict.fromkeys(Path(p) for p in image_paths))

    def __len__(self):
        return len(self.image_paths)


DATASETS: Registry = Registry("dataset")


def get_datasets(
    dataset: str = "Sketchy",
    size: float = 0.1,
    sketch_format: str = "png",
    img_format: str = "jpg",
    sketch_type="placeholder",
    img_type: str = "photos",
    split_ratio: float = 0.1,
    seed: int = 42,
    root: Optional[Path] = None,
    **kw,
) -> Tuple[Optional[RetrievalCatalog], RetrievalCatalog]:
    """(train, test) catalog pair; flag surface of reference
    `data_preparation.py:796`."""
    # canonical aliases as in the reference factory
    aliases = {
        "Sketchy": "SketchyV1",
        "SketchyDatasetV1": "SketchyV1",
        "SketchyDatasetV2": "SketchyV2",
        "VectorizedSketchyDatasetV1": "VectorizedSketchyV1",
        "SketchyDatasetPix2Pix": "SketchyPix2Pix",
        "Kaggle": "KaggleV1",
        "KaggleDatasetV1": "KaggleV1",
        "KaggleDatasetV2": "KaggleV2",
        "AugmentedKaggleDatasetV1": "AugmentedKaggleV1",
        "AugmentedKaggleDatasetV2": "AugmentedKaggleV2",
        "KaggleInferencedatasetV1": "KaggleInferenceV1",
    }
    key = aliases.get(dataset, dataset)
    if key.startswith("MixedDataset"):
        version = key[-2:]
        factory = DATASETS["MixedDataset"]
        kw = dict(kw, version=version)
    else:
        factory = DATASETS[key]
    common = dict(
        size=size, sketch_format=sketch_format, img_format=img_format,
        sketch_type=sketch_type, img_type=img_type, split_ratio=split_ratio,
        seed=seed, root=root, **kw,
    )
    return factory(mode="train", **common), factory(mode="test", **common)
