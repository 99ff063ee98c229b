"""Sketchy dataset catalogs (counterpart of ``art_sbir_tpu/data/sketchy.py``).

Pairing and split semantics of the reference Sketchy datasets
(`data_preparation.py:119-226`): classes are the sorted directory names
under ``data/sketchy/<img_type>``, truncated to ``round(size * n_classes)``;
sketches are globbed per class from ``sketches_<fmt>``; each sketch's photo
is derived from the ``n\\d+_\\d+`` ImageNet id in its filename (or the full
stem for AdaIN ``artworks``); the 90/10 split runs with seed 42 over the
paired lists. V2 adds class labels and same-class negatives. The pix2pix
table (``SketchyDatasetPix2Pix``) comes with the pix2pix slice.
"""

from __future__ import annotations

import os
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

from art_sbir_tpu_torch.data.catalog import DATASETS, RetrievalCatalog

_IMAGENET_ID = re.compile(r"n\d+_\d+")


class SketchyCatalogV1(RetrievalCatalog):
    name = "SketchyDatasetV1"

    def __init__(
        self,
        sketch_format="png",
        img_format="jpg",
        img_type="photos",
        mode="train",
        split_ratio=0.1,
        size=1.0,
        seed=42,
        max_erase_count=99999,
        only_valid=True,
        root: Optional[Path] = None,
        do_split=True,
        **_,
    ):
        super().__init__(sketch_format, img_format, img_type, mode, split_ratio, size, seed)
        self.path = Path(root) if root else Path("data/sketchy")
        self.only_valid = only_valid
        self.max_erase_count = max_erase_count

        self.classes, self.classes_to_idx = self._sketchy_classes()
        self._load_paths()
        if do_split:
            self.sketch_paths, self.photo_paths = self._sample_split(
                [self.sketch_paths, self.photo_paths]
            )

    def _sketchy_classes(self):
        """First round(size * n) of the sorted class dirs
        (reference `data_preparation.py:140-150`)."""
        img_dir = self.path / self.img_type
        classes = sorted(e.name for e in os.scandir(img_dir) if e.is_dir())
        if not classes:
            raise FileNotFoundError(f"No classes found in {img_dir}")
        classes = classes[: round(self.size * len(classes))]
        return classes, {c: i for i, c in enumerate(classes)}

    def _load_paths(self):
        """Glob sketches; derive the paired photo path per sketch
        (reference `data_preparation.py:166-178`)."""
        for cls in self.classes:
            self.sketch_paths += sorted(
                (self.path / f"sketches_{self.sketch_format}").glob(
                    f"{cls}/*.{self.sketch_format}"
                )
            )
        for p in self.sketch_paths:
            if self.img_type == "artworks":
                filename = f"{p.stem}.{self.img_format}"
            else:
                filename = f"{_IMAGENET_ID.search(p.name).group()}.{self.img_format}"
            self.photo_paths.append(self.path / self.img_type / p.parent.name / filename)

    @property
    def state_dict(self) -> Dict:
        d = super().state_dict
        d["valid_only"] = self.only_valid
        d["max_erase_count"] = self.max_erase_count
        return d


class SketchyCatalogV2(SketchyCatalogV1):
    """Adds class label + same-class negative
    (reference `data_preparation.py:200-226`)."""

    name = "SketchyDatasetV2"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.categorized: Dict[str, list] = defaultdict(list)
        for i, p in enumerate(self.photo_paths):
            self.categorized[p.parent.stem].append(i)
        self.labels = [self.classes_to_idx[p.parent.stem] for p in self.photo_paths]
        # classes where every pool entry is the same photo (one distinct
        # image survived the split) would spin the redraw loop forever —
        # the reference has the same hazard (`data_preparation.py:214-222`)
        self._distinct = {
            cls: len({str(self.photo_paths[j]) for j in pool})
            for cls, pool in self.categorized.items()
        }

    def negative_index(self, idx: int) -> int:
        """Uniform over class-mates, excluding the positive (the reference
        redraws until the pick differs, `data_preparation.py:214-222`)."""
        cls = self.photo_paths[idx].parent.stem
        pool = self.categorized[cls]
        if self._distinct.get(cls, 0) <= 1:
            return idx
        while True:
            j = pool[self.rng.randrange(len(pool))]
            if self.photo_paths[j] != self.photo_paths[idx]:
                return j


DATASETS.register("SketchyV1", SketchyCatalogV1)
DATASETS.register("SketchyV2", SketchyCatalogV2)
