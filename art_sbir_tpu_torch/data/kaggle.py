"""Kaggle art dataset catalogs (counterpart of ``art_sbir_tpu/data/kaggle.py``).

CSV-driven (``data/kaggle/kaggle_art_dataset_{train,test}.csv``) like the
reference (`data_preparation.py:469-722`): images truncated to
``int(n * size)`` head rows; style/genre categoricals from sorted uniques;
V2 pairs genre-matched negatives and carries the reference's deliberate
test-time genre off-by-one patch ('miniature' missing from the test CSV,
`data_preparation.py:552`); sketch variants join ``data/kaggle/
<sketch_type>/<stem>.png`` (a list of sketch_types means a random source per
sample, `data_preparation.py:582-584`). The reference's hard-coded cluster
paths become a ``root`` parameter.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional

from art_sbir_tpu_torch.data.catalog import DATASETS, RetrievalCatalog


def _read_csv(path: Path) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class KaggleImgOnlyV1(RetrievalCatalog):
    """Image-only corpus: per index one artwork + metadata
    (reference `data_preparation.py:469-533`)."""

    name = "KaggleDatasetImgOnlyV1"

    def __init__(
        self,
        img_format="jpg",
        img_type="images",
        mode="train",
        size=0.1,
        seed=42,
        root: Optional[Path] = None,
        **_,
    ):
        super().__init__("png", img_format, img_type, mode, 0.0, size, seed)
        self.root = Path(root) if root else Path("data/kaggle")
        self.image_path = self.root / self.img_type

        rows = _read_csv(self.root / f"kaggle_art_dataset_{mode}.csv")
        rows = rows[: int(len(rows) * self.size)]
        self.rows = rows
        self.photo_paths = [self.image_path / r["filename"] for r in rows]

        self.styles = self._classes("style")
        self.genres = self._classes("genre")

    def _classes(self, key: str) -> Dict[str, int]:
        vals = sorted({r[key] for r in self.rows})
        return {v: i for i, v in enumerate(vals)}

    def __len__(self):
        return len(self.rows)

    def item(self, idx: int) -> Dict:
        return {
            "image": self.photo_paths[idx],
            "name": self.photo_paths[idx].stem,
            "path": str(self.photo_paths[idx]),
        }

    @property
    def state_dict(self) -> Dict:
        d = super().state_dict
        d.pop("split_ratio", None)
        d["num_styles"] = len(self.styles)
        d["num_genres"] = len(self.genres)
        return d


class KaggleImgOnlyV2(KaggleImgOnlyV1):
    """Adds genre-matched negative + style/genre labels
    (reference `data_preparation.py:536-558`)."""

    name = "KaggleDatasetImgOnlyV2"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.by_genre: Dict[str, List[int]] = {}
        for i, r in enumerate(self.rows):
            self.by_genre.setdefault(r["genre"], []).append(i)

    def genre_label(self, idx: int) -> int:
        r = self.rows[idx]
        label = self.genres[r["genre"]]
        # test CSV lacks genre 'miniature'; labels after it shift by one to
        # line up with the train label space (reference patch,
        # data_preparation.py:552)
        if self.mode == "test" and r["genre"] > "miniature":
            label += 1
        return label

    def negative_index(self, idx: int) -> int:
        pool = self.by_genre[self.rows[idx]["genre"]]
        return pool[self.rng.randrange(len(pool))]

    def item(self, idx: int) -> Dict:
        return {
            "positive": self.photo_paths[idx],
            "negative": self.photo_paths[self.negative_index(idx)],
            "label": self.styles[self.rows[idx]["style"]],
            "label2": self.genre_label(idx),
        }


class _SketchJoin:
    """Shared sketch-joining logic for KaggleV1/V2."""

    def _init_sketches(self, sketch_type, sketch_format):
        self.sketch_type = sketch_type
        self.sketch_format = sketch_format
        first = sketch_type[0] if isinstance(sketch_type, list) else sketch_type
        self.sketch_path = self.root / str(first)
        self.sketch_paths = [
            self.sketch_path / f"{p.stem}.{sketch_format}" for p in self.photo_paths
        ]

    def sketch_for(self, idx: int) -> Path:
        p = self.sketch_paths[idx]
        if isinstance(self.sketch_type, list):
            src = self.sketch_type[self.rng.randrange(len(self.sketch_type))]
            return self.sketch_path.parent / src / p.name
        return p


class KaggleCatalogV1(_SketchJoin, KaggleImgOnlyV1):
    """(sketch, pos, neg) with uniform negatives
    (reference `data_preparation.py:561-597`)."""

    name = "KaggleDatasetV1"

    def __init__(self, sketch_format="png", sketch_type="contour_drawings", **kw):
        KaggleImgOnlyV1.__init__(self, **kw)
        self._init_sketches(sketch_type, sketch_format)

    def item(self, idx: int) -> Dict:
        return {
            "sketch": self.sketch_for(idx),
            "positive": self.photo_paths[idx],
            "negative": self.photo_paths[self.rng.randrange(len(self.photo_paths))],
        }

    @property
    def state_dict(self):
        d = super().state_dict
        d["sketch_type"] = self.sketch_type
        d["sketch_format"] = self.sketch_format
        return d


class KaggleCatalogV2(_SketchJoin, KaggleImgOnlyV2):
    """(sketch, pos, neg, style, genre) with genre-matched negatives
    (reference `data_preparation.py:600-634`)."""

    name = "KaggleDatasetV2"

    def __init__(self, sketch_format="png", sketch_type="contour_drawings", **kw):
        KaggleImgOnlyV2.__init__(self, **kw)
        self._init_sketches(sketch_type, sketch_format)

    def item(self, idx: int) -> Dict:
        base = KaggleImgOnlyV2.item(self, idx)
        base["sketch"] = self.sketch_for(idx)
        return base

    @property
    def state_dict(self):
        d = super().state_dict
        d["sketch_type"] = self.sketch_type
        d["sketch_format"] = self.sketch_format
        return d


class AugmentedKaggleCatalogV1(KaggleCatalogV1):
    """Same table; the loader applies paired hflip + sketch augmentation V1
    in train mode (reference `data_preparation.py:637-667`). The flag below
    tells the loader/step which device-side augmentation to run."""

    name = "AugmentedKaggleDatasetV1"
    augment_sketches = 1  # sketch_transformV1
    # the reference Augmented datasets discard the passed model.transform
    # and use image_transformV1 = square Resize((224,224))
    # (`data_preparation.py:641`, `transformations.py:9-15`)
    resize_mode = "square"

    def item(self, idx: int) -> Dict:
        out = super().item(idx)
        out["augment"] = 1
        return out

    @property
    def state_dict(self):
        d = super().state_dict
        d["sketch_transform_name"] = "sketch_transformV1"
        d["sketch_transform"] = "device sketch_augment v1 + paired random hflip"
        return d


class AugmentedKaggleCatalogV2(KaggleCatalogV2):
    name = "AugmentedKaggleDatasetV2"
    augment_sketches = 1
    resize_mode = "square"  # reference data_preparation.py:670

    def item(self, idx: int) -> Dict:
        out = super().item(idx)
        out["augment"] = 1
        return out

    @property
    def state_dict(self):
        d = super().state_dict
        d["sketch_transform_name"] = "sketch_transformV1"
        d["sketch_transform"] = "device sketch_augment v1 + paired random hflip"
        return d


class KaggleInferenceCatalogV1:
    """Human sketches from sketchit (``categorized_sketches.csv`` filtered
    ``valid == 1``), query-only (reference `data_preparation.py:696-722`)."""

    name = "KaggleInferenceDatasetV1"

    # the reference passes the *calling* dataset's transform
    # (`inference.py:158`); run_inference resolves the mode from the main
    # dataset, so this default only matters for standalone use
    resize_mode = "shortest_crop"

    def __init__(self, sketch_type="sketches", sketch_format="png",
                 root: Optional[Path] = None, **_):
        self.root = Path(root) if root else Path("data/kaggle")
        self.sketch_type, self.sketch_format = sketch_type, sketch_format
        rows = _read_csv(self.root / "categorized_sketches.csv")
        self.sketch_paths = [
            self.root / sketch_type / r["sketch"] for r in rows if r["valid"] == "1"
        ]

    def __len__(self):
        return len(self.sketch_paths)

    @property
    def state_dict(self):
        return {
            "dataset": self.name,
            "img_number": len(self),
            "sketch_type": self.sketch_type,
            "sketch_format": self.sketch_format,
        }


def _kaggle_inference_factory(mode="test", **kw):
    if mode == "train":
        return None
    return KaggleInferenceCatalogV1(
        sketch_type=kw.get("sketch_type", "sketches"),
        sketch_format=kw.get("sketch_format", "png"),
        root=kw.get("root"),
    )


def _imgonly_v1(mode="train", **kw):
    return KaggleImgOnlyV1(
        img_format=kw.get("img_format", "jpg"), img_type=kw.get("img_type", "images"),
        mode=mode, size=kw.get("size", 0.1), seed=kw.get("seed", 42),
        root=kw.get("root"),
    )


def _imgonly_v2(mode="train", **kw):
    return KaggleImgOnlyV2(
        img_format=kw.get("img_format", "jpg"), img_type=kw.get("img_type", "images"),
        mode=mode, size=kw.get("size", 0.1), seed=kw.get("seed", 42),
        root=kw.get("root"),
    )


def _kaggle(cls):
    def make(mode="train", **kw):
        return cls(
            sketch_format=kw.get("sketch_format", "png"),
            sketch_type=kw.get("sketch_type", "contour_drawings"),
            img_format=kw.get("img_format", "jpg"),
            img_type=kw.get("img_type", "images"),
            mode=mode, size=kw.get("size", 0.1), seed=kw.get("seed", 42),
            root=kw.get("root"),
        )

    return make


DATASETS.register("KaggleDatasetImgOnlyV1", _imgonly_v1)
DATASETS.register("KaggleDatasetImgOnlyV2", _imgonly_v2)
DATASETS.register("KaggleV1", _kaggle(KaggleCatalogV1))
DATASETS.register("KaggleV2", _kaggle(KaggleCatalogV2))
DATASETS.register("AugmentedKaggleV1", _kaggle(AugmentedKaggleCatalogV1))
DATASETS.register("AugmentedKaggleV2", _kaggle(AugmentedKaggleCatalogV2))
DATASETS.register("KaggleInferenceV1", _kaggle_inference_factory)
