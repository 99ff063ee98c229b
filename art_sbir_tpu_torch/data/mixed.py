"""Mixed Kaggle+Sketchy catalogs (counterpart of ``art_sbir_tpu/data/mixed.py``).

Interleaving semantics of the reference (`data_preparation.py:724-792`):
train length is ``2 * max(len_kaggle, len_sketchy)``; even indices map to
Kaggle, odd to Sketchy, both wrapping modulo their lengths; test mode serves
Kaggle only. Version selection is an explicit table (the reference uses
``eval`` on class-name strings, `data_preparation.py:735-739`):

  V1 -> AugmentedKaggleV1 + SketchyV1      V2 -> AugmentedKaggleV2 + SketchyV2
  V3 -> AugmentedKaggleV1 + SketchyV2      V4 -> KaggleV2 + SketchyV2

``CategorizedMixedDatasetV2`` additionally yields a genre label, with the
sentinel ``num_genres`` for Sketchy samples (`data_preparation.py:788`).
"""

from __future__ import annotations

from typing import Dict, Optional

from art_sbir_tpu_torch.data.catalog import DATASETS
from art_sbir_tpu_torch.data.kaggle import (
    AugmentedKaggleCatalogV1,
    AugmentedKaggleCatalogV2,
    KaggleCatalogV2,
)
from art_sbir_tpu_torch.data.sketchy import SketchyCatalogV1, SketchyCatalogV2

_VERSIONS = {
    "V1": (AugmentedKaggleCatalogV1, SketchyCatalogV1),
    "V2": (AugmentedKaggleCatalogV2, SketchyCatalogV2),
    "V3": (AugmentedKaggleCatalogV1, SketchyCatalogV2),
    "V4": (KaggleCatalogV2, SketchyCatalogV2),
}


class MixedCatalog:
    name = "MixedDataset"

    # the reference factory constructs Mixed datasets WITHOUT forwarding
    # model.transform (`data_preparation.py:837-841`), so they fall back to
    # the square image_transformV1 default (`data_preparation.py:725`)
    resize_mode = "square"

    def __init__(
        self,
        mode="train",
        sketch_type="contour_drawings",
        sketchy_img_type="photos",
        size=1.0,
        version="V1",
        sketch_format="png",
        root_kaggle: Optional[str] = None,
        root_sketchy: Optional[str] = None,
        **_,
    ):
        self.mode, self.size, self.version = mode, size, version
        self.sketch_type, self.sketchy_img_type = sketch_type, sketchy_img_type
        kaggle_cls, sketchy_cls = _VERSIONS[version]
        self.kaggle = kaggle_cls(
            mode=mode, size=size, sketch_type=sketch_type,
            sketch_format=sketch_format, root=root_kaggle,
        )
        self.sketchy = sketchy_cls(
            mode=mode, size=size, img_type=sketchy_img_type, root=root_sketchy
        )
        # gallery for inference = kaggle side (reference
        # data_preparation.py:742-744)
        self.photo_paths = self.kaggle.photo_paths
        self.sketch_paths = self.kaggle.sketch_paths

    def __len__(self) -> int:
        if self.mode == "train":
            return 2 * max(len(self.sketchy), len(self.kaggle))
        return len(self.sketch_paths)

    def _route(self, idx: int):
        if self.mode == "test":
            return self.kaggle, idx
        if idx % 2 == 0:
            return self.kaggle, (idx // 2) % len(self.kaggle)
        return self.sketchy, ((idx - 1) // 2) % len(self.sketchy)

    @property
    def augment_sketches(self) -> int:
        """Device-side augmentation applies to the Kaggle-sourced samples
        only (the reference's Augmented sub-dataset transforms its own
        items, `data_preparation.py:644-657`); the per-item 'augment' mask
        carries this to the batch finisher."""
        return getattr(self.kaggle, "augment_sketches", 0)

    def item(self, idx: int) -> Dict:
        src, j = self._route(idx)
        it = src.item(j)
        out = {k: it[k] for k in ("sketch", "positive", "negative")}
        out["augment"] = int(it.get("augment", 0)) if src is self.kaggle else 0
        return out

    @property
    def state_dict(self) -> Dict:
        return {
            "dataset": "MixedDataset",
            "version": self.version,
            "img_number": len(self),
            "size": self.size,
            "mode": self.mode,
            "sketch_type": self.sketch_type,
            "sketchy_img_type": self.sketchy_img_type,
            "kaggle": self.kaggle.state_dict,
            "sketchy": self.sketchy.state_dict,
        }


class CategorizedMixedCatalogV2(MixedCatalog):
    """Genre-labeled mixed dataset (reference `data_preparation.py:760-792`)."""

    name = "CategorizedMixedDatasetV2"

    def __init__(self, **kw):
        kw.pop("version", None)
        super().__init__(version="V2", **kw)
        self.num_classes = len(self.kaggle.genres)

    def item(self, idx: int) -> Dict:
        src, j = self._route(idx)
        it = src.item(j)
        out = {k: it[k] for k in ("sketch", "positive", "negative")}
        out["augment"] = int(it.get("augment", 0)) if src is self.kaggle else 0
        if src is self.kaggle:
            out["label"] = it["label2"]  # genre head
        else:
            out["label"] = self.num_classes  # sketchy sentinel class
        return out

    @property
    def state_dict(self) -> Dict:
        d = super().state_dict
        d["dataset"] = self.name
        d["num_classes"] = self.num_classes
        return d


def _mixed(mode="train", **kw):
    return MixedCatalog(
        mode=mode,
        sketch_type=kw.get("sketch_type", "contour_drawings"),
        sketchy_img_type=kw.get("img_type", "photos"),
        size=kw.get("size", 1.0),
        version=kw.get("version", "V1"),
        sketch_format=kw.get("sketch_format", "png"),
        root_kaggle=kw.get("root_kaggle") or kw.get("root"),
        root_sketchy=kw.get("root_sketchy"),
    )


def _categorized(mode="train", **kw):
    return CategorizedMixedCatalogV2(
        mode=mode,
        sketch_type=kw.get("sketch_type", "contour_drawings"),
        sketchy_img_type=kw.get("img_type", "photos"),
        size=kw.get("size", 1.0),
        sketch_format=kw.get("sketch_format", "png"),
        root_kaggle=kw.get("root_kaggle") or kw.get("root"),
        root_sketchy=kw.get("root_sketchy"),
    )


DATASETS.register("MixedDataset", _mixed)
DATASETS.register("CategorizedMixedDatasetV2", _categorized)
