"""Synthetic on-disk corpora in the Sketchy and Kaggle layouts.

Counterpart of ``art_sbir_tpu/data/synthetic.py``: the same seeds write
the same files, byte for byte. The real corpora are multi-GB downloads
(reference `data_setup.py`), so tests and smoke runs use deterministic
miniatures with the directory and CSV contracts the catalogs expect:
uniform-noise photos and random polyline sketches. The learnable corpus
and the SVG strokes come with the training and stroke slices. PIL is
imported inside the functions.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import List

import numpy as np

STYLES = ["Baroque", "Cubism", "Impressionism"]
GENRES = ["abstract", "landscape", "miniature", "portrait"]


def _img(seed: int, size: int = 96, sketch: bool = False):
    """A seeded PIL image: a 6-point black polyline on white (``sketch``)
    or uniform RGB noise."""
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(seed)
    if sketch:
        img = Image.new("RGB", (size, size), (255, 255, 255))
        draw = ImageDraw.Draw(img)
        pts = rng.integers(5, size - 5, size=(6, 2))
        draw.line([tuple(p) for p in pts], fill=(0, 0, 0), width=2)
        return img
    arr = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
    return Image.fromarray(arr)


def make_synthetic_sketchy(root: Path | str, n_classes: int = 3,
                           photos_per_class: int = 3,
                           sketches_per_photo: int = 2,
                           size: int = 96) -> Path:
    """data/sketchy layout: ``photos/<class>/nX_Y.jpg`` and
    ``sketches_png/<class>/nX_Y-k.png``."""
    root = Path(root)
    for ci in range(n_classes):
        cls = f"class{ci:02d}"
        (root / "photos" / cls).mkdir(parents=True, exist_ok=True)
        (root / "sketches_png" / cls).mkdir(parents=True, exist_ok=True)
        for pi in range(photos_per_class):
            img_id = f"n{ci:08d}_{pi}"
            _img(ci * 100 + pi, size).save(root / "photos" / cls / f"{img_id}.jpg")
            for si in range(1, sketches_per_photo + 1):
                _img(ci * 1000 + pi * 10 + si, size, sketch=True).save(
                    root / "sketches_png" / cls / f"{img_id}-{si}.png")
    return root


def make_synthetic_kaggle(root: Path | str, n_train: int = 12,
                          n_test: int = 6, size: int = 96,
                          sketch_types: List[str] = ("contour_drawings",)
                          ) -> Path:
    """data/kaggle layout: ``images/``, ``<sketch_type>/``, the two CSVs,
    ``categorized_sketches.csv`` and ``sketches/`` (the human queries)."""
    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    for st in sketch_types:
        (root / st).mkdir(parents=True, exist_ok=True)
    (root / "sketches").mkdir(parents=True, exist_ok=True)

    def write_split(mode: str, n: int, offset: int):
        rows = []
        genres = GENRES if mode == "train" else [g for g in GENRES if g != "miniature"]
        for i in range(n):
            fid = offset + i
            fname = f"{fid}.jpg"
            _img(fid, size).save(root / "images" / fname)
            for st in sketch_types:
                _img(fid + 5000, size, sketch=True).save(root / st / f"{fid}.png")
            rows.append({"filename": fname, "style": STYLES[i % len(STYLES)],
                         "genre": genres[i % len(genres)]})
        with open(root / f"kaggle_art_dataset_{mode}.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["filename", "style", "genre"])
            w.writeheader()
            w.writerows(rows)
        return rows

    write_split("train", n_train, 0)
    test_rows = write_split("test", n_test, 1000)

    # human query sketches referencing test image ids
    with open(root / "categorized_sketches.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["sketch", "valid", "category"])
        w.writeheader()
        for i, r in enumerate(test_rows):
            stem = Path(r["filename"]).stem
            sname = f"{i}-{stem}-{i * 37 % 97}.png"
            _img(9000 + i, size, sketch=True).save(root / "sketches" / sname)
            w.writerow({"sketch": sname, "valid": 1, "category": r["genre"]})
    return root
