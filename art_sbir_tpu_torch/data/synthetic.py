"""Synthetic on-disk corpora in the Sketchy and Kaggle layouts.

Counterpart of ``art_sbir_tpu/data/synthetic.py``: the same seeds write
the same files, byte for byte. The real corpora are multi-GB downloads
(reference `data_setup.py`), so tests and smoke runs use deterministic
miniatures with the directory and CSV contracts the catalogs expect:
uniform-noise photos and random polyline sketches, or (``learnable=True``)
photos of outlined shapes with sketches that outline the same shapes, on
which triplet training visibly learns; ``with_svg=True`` adds Sketchy-style
vector sketches (``sketches_svg/``) for the stroke catalogs. PIL is
imported inside the functions.
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
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


def _svg(seed: int, w: int = 640, h: int = 480) -> str:
    """A Sketchy-style SVG: each stroke its own <path>, one leading moveto
    then line and cubic-bezier segments (stroke #000)."""
    rng = np.random.default_rng(seed)
    parts = []
    for p in range(int(rng.integers(2, 5))):
        x, y = float(rng.integers(50, 400)), float(rng.integers(50, 400))
        d = f"m{x},{y}"
        for _ in range(int(rng.integers(6, 14))):
            if rng.random() < 0.4:  # cubic bezier, relative control points
                c = rng.normal(0, 12, 6).round(2)
                d += f"c{c[0]},{c[1]} {c[2]},{c[3]} {c[4]},{c[5]}"
            else:
                dx, dy = rng.normal(0, 18, 2).round(2)
                d += f"l{dx},{dy}"
        parts.append(
            f'<path d="{d}" id="p{seed}_{p}" stroke-width="2" stroke="#000" fill="none"/>'
        )
    return (
        f'<svg width="{w}" height="{h}" xmlns="http://www.w3.org/2000/svg">\n'
        + "\n".join(parts)
        + "\n</svg>\n"
    )


def _shape_params(class_id: int, photo_id: int) -> list:
    """The shapes of one photo instance: shape 0's type encodes the CLASS
    (a signal for the classification head), the others' types, places,
    sizes and colors the INSTANCE (a signal for the triplet loss). Tuples
    (shape_type, cx, cy, rx, ry, angle, rgb), in fractions of the image
    size."""
    rng = np.random.default_rng(1_000_003 * class_id + photo_id)
    shapes = []
    n_shapes = 2 + int(rng.integers(0, 2))  # 2 or 3 shapes
    # each shape in its own quadrant (seeded order): no photo shape hides
    # another that the sketch still outlines
    quads = rng.permutation(4)[:n_shapes]
    for s in range(n_shapes):
        stype = class_id % 3 if s == 0 else int(rng.integers(0, 3))
        qx, qy = quads[s] % 2, quads[s] // 2
        cx = 0.25 + 0.5 * qx + rng.uniform(-0.08, 0.08)
        cy = 0.25 + 0.5 * qy + rng.uniform(-0.08, 0.08)
        rx = rng.uniform(0.10, 0.20)
        ry = rx * rng.uniform(0.6, 1.0)
        angle = float(rng.uniform(0, 2 * np.pi))
        color = tuple(int(c) for c in rng.integers(40, 216, 3))
        shapes.append((stype, float(cx), float(cy), float(rx), float(ry),
                       angle, color))
    return shapes


def _shape_points(stype, cx, cy, rx, ry, angle, size) -> list:
    """Polygon vertices (pixels) of a rectangle or triangle; None for an
    ellipse."""
    if stype == 0:
        return None  # axis-aligned ellipse
    n = 4 if stype == 1 else 3
    pts = []
    for k in range(n):
        t = angle + 2 * np.pi * k / n
        pts.append((cx * size + rx * size * np.cos(t),
                    cy * size + ry * size * np.sin(t)))
    return pts


def _draw_shape(draw, stype, cx, cy, rx, ry, angle, size, width,
                fill=None) -> None:
    pts = _shape_points(stype, cx, cy, rx, ry, angle, size)
    if pts is None:
        bbox = [(cx - rx) * size, (cy - ry) * size,
                (cx + rx) * size, (cy + ry) * size]
        draw.ellipse(bbox, fill=fill, outline=(0, 0, 0), width=width)
    else:
        draw.polygon(pts, fill=fill, outline=(0, 0, 0), width=width)


def _learnable_photo(class_id: int, photo_id: int, size: int):
    """A photo: outlined, lightly filled shapes on a bright background, so
    photo and sketch share edges and pixel moments (one set of running
    BatchNorm statistics serves both at inference)."""
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(7_000_003 * class_id + photo_id + 13)
    base = rng.integers(215, 245)
    grad = np.linspace(-12, 12, size)[:, None]
    arr = np.clip(base + grad + rng.normal(0, 5, (size, size)), 0, 255)
    arr = np.repeat(arr[..., None], 3, -1).astype(np.uint8)
    img = Image.fromarray(arr)
    draw = ImageDraw.Draw(img)
    width = max(1, size // 48)
    for stype, cx, cy, rx, ry, angle, color in _shape_params(class_id,
                                                             photo_id):
        fill = tuple(int(160 + 0.35 * c) for c in color)  # muted fill
        _draw_shape(draw, stype, cx, cy, rx, ry, angle, size, width, fill)
    return img


def _learnable_sketch(class_id: int, photo_id: int, sketch_id: int,
                      size: int):
    """A sketch: black outlines of the SAME shapes on white, each with a
    small hand-drawn jitter of center, size and rotation."""
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(
        900_000_007 * class_id + 1_009 * photo_id + sketch_id)
    img = Image.new("RGB", (size, size), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    for stype, cx, cy, rx, ry, angle, _ in _shape_params(class_id, photo_id):
        cx += rng.normal(0, 0.012)
        cy += rng.normal(0, 0.012)
        rx *= rng.uniform(0.92, 1.08)
        ry *= rng.uniform(0.92, 1.08)
        angle += rng.normal(0, 0.05)
        _draw_shape(draw, stype, cx, cy, rx, ry, angle, size,
                    max(1, size // 48))
    return img


def make_synthetic_sketchy(root: Path | str, n_classes: int = 3,
                           photos_per_class: int = 3,
                           sketches_per_photo: int = 2,
                           size: int = 96, with_svg: bool = False,
                           learnable: bool = False) -> Path:
    """data/sketchy layout: ``photos/<class>/nX_Y.jpg`` and
    ``sketches_png/<class>/nX_Y-k.png`` (and ``sketches_svg/<class>/
    nX_Y-k.svg`` with ``with_svg``). ``learnable=True`` draws each sketch
    as a line drawing of its photo's shapes, so training moves recall
    above chance. Classes are written by a pool of threads (PIL's
    encoders release the GIL); every image has its own seed, so the files
    do not depend on the order."""
    root = Path(root)

    def write_class(ci: int) -> None:
        cls = f"class{ci:02d}"
        (root / "photos" / cls).mkdir(parents=True, exist_ok=True)
        (root / "sketches_png" / cls).mkdir(parents=True, exist_ok=True)
        if with_svg:
            (root / "sketches_svg" / cls).mkdir(parents=True, exist_ok=True)
        for pi in range(photos_per_class):
            img_id = f"n{ci:08d}_{pi}"
            photo = (_learnable_photo(ci, pi, size) if learnable
                     else _img(ci * 100 + pi, size))
            photo.save(root / "photos" / cls / f"{img_id}.jpg")
            for si in range(1, sketches_per_photo + 1):
                sketch = (_learnable_sketch(ci, pi, si, size) if learnable
                          else _img(ci * 1000 + pi * 10 + si, size,
                                    sketch=True))
                sketch.save(root / "sketches_png" / cls / f"{img_id}-{si}.png")
                if with_svg:
                    (root / "sketches_svg" / cls / f"{img_id}-{si}.svg"
                     ).write_text(_svg(ci * 1000 + pi * 10 + si))

    from PIL import Image

    Image.init()  # the format plugins, once, before the threads save
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(write_class, range(n_classes)))
    return root


def make_synthetic_quickdraw(root: Path | str, n_train: int = 40,
                             n_valid: int = 10, seed: int = 0) -> Path:
    """QuickDraw's layout: one ``<category>.npz`` a category (the six
    defaults of :mod:`art_sbir_tpu_torch.data.quickdraw`) holding
    ``train``, ``valid`` and ``test`` object arrays of int16 stroke-3
    sketches, 12 to 80 rows each, pen lifts about one row in eight and
    always on the last row. A port addition: JAX's synthetic module writes
    no QuickDraw."""
    from art_sbir_tpu_torch.data.quickdraw import CATEGORIES

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    def sketches(n):
        out = np.empty(n, dtype=object)
        for i in range(n):
            t = int(rng.integers(12, 81))
            s = np.zeros((t, 3), np.int16)
            s[:, :2] = rng.normal(0, 20, (t, 2)).round()
            s[:, 2] = rng.random(t) < 0.125
            s[-1, 2] = 1
            out[i] = s
        return out

    for cat in CATEGORIES:
        np.savez(root / f"{cat}.npz", train=sketches(n_train),
                 valid=sketches(n_valid), test=sketches(n_valid))
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
