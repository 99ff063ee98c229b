"""Data acquisition CLI (reference `data_setup.py`).

    python -m art_sbir_tpu_torch.cli.data_setup [--synthetic [--learnable]]
        [--kaggle_split] [--kaggle_copy_test <image dir>]
        [--sketchy_download] [--root data]

Counterpart of ``art_sbir_tpu/cli/data_setup.py``, with the same flags:

* ``--synthetic`` writes the miniature corpora of the tests and smoke
  runs under ``<root>/sketchy`` (with SVGs; ``--learnable``: sketches
  drawn from their photos) and ``<root>/kaggle``, through the port's
  ``data/synthetic.py``;
* ``--kaggle_split`` builds ``kaggle_art_dataset_{train,test}.csv`` from
  ``<root>/kaggle/all_data_info.csv`` by the reference's recipe
  (`data/kaggle/kaggle_info.py`): genres, then styles, with fewer than
  100 images go, then a seeded permutation takes the test rows. It reads
  and writes the CSVs with the ``csv`` module as pandas does (its empty
  and NA spellings dropped, minimal quoting, ``\\n`` line ends), so the
  files are the JAX CLI's byte for byte without pandas;
* ``--kaggle_copy_test`` copies the test split's images into
  ``<root>/kaggle/photos/test`` (reference `get_kaggle_test.py`);
* ``--sketchy_download`` fetches and unpacks the Sketchy archives. It
  needs the network, which the machines this port is tested on lack.
"""

from __future__ import annotations

import argparse
import csv
import shutil
import urllib.request
import zipfile
from pathlib import Path
from typing import Dict, List

import numpy as np

SKETCHY_URLS = {
    # the public Sketchy database mirrors used by the reference
    "photos": "https://sketchy.eye.gatech.edu/rendered_256x256.7z",
    "sketches": "https://sketchy.eye.gatech.edu/sketches_png.zip",
    "svgs": "https://sketchy.eye.gatech.edu/sketches_svg.zip",
}
# the strings pandas.read_csv reads as missing by default
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
COLUMNS = ("filename", "style", "genre")


def download(url: str, dest: Path) -> Path:
    dest.parent.mkdir(parents=True, exist_ok=True)
    if dest.exists():
        print(f"{dest} already present", flush=True)
        return dest
    print(f"downloading {url} -> {dest}", flush=True)
    with urllib.request.urlopen(url) as r, open(dest, "wb") as f:
        shutil.copyfileobj(r, f)
    return dest


def unpack(archive: Path, dest: Path) -> None:
    dest.mkdir(parents=True, exist_ok=True)
    if archive.suffix == ".zip":
        with zipfile.ZipFile(archive) as z:
            z.extractall(dest)
    else:
        raise RuntimeError(
            f"cannot unpack {archive} here; extract it into {dest} by hand")


def _write_csv(path: Path, rows: List[Dict[str, str]]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(COLUMNS)
        w.writerows([r[c] for c in COLUMNS] for r in rows)


def build_kaggle_split(kaggle_dir: Path, test_size: int = 6000,
                       seed: int = 2, min_count: int = 100) -> None:
    """``kaggle_art_dataset_{train,test}.csv`` from an all-data CSV with
    filename (or new_filename), style and genre columns: rows missing one
    of them go, then genres and styles with fewer than ``min_count``
    images, then ``RandomState(seed).permutation`` puts ``min(test_size,
    rows // 10)`` rows in the test split, in permuted order, and the rest
    in the train split."""
    src = kaggle_dir / "all_data_info.csv"
    if not src.is_file():
        raise FileNotFoundError(
            f"expected {src} (Kaggle painter-by-numbers info)")
    with open(src, newline="") as f:
        reader = csv.DictReader(f)
        name = ("new_filename" if "new_filename" in reader.fieldnames
                else "filename")
        rows = [{"filename": r[name], "style": r["style"],
                 "genre": r["genre"]} for r in reader]
    rows = [r for r in rows if not any(r[c] in NA_VALUES for c in COLUMNS)]
    for col in ("genre", "style"):
        counts: Dict[str, int] = {}
        for r in rows:
            counts[r[col]] = counts.get(r[col], 0) + 1
        rows = [r for r in rows if counts[r[col]] >= min_count]

    perm = np.random.RandomState(seed).permutation(len(rows))
    n_test = min(test_size, len(rows) // 10)
    _write_csv(kaggle_dir / "kaggle_art_dataset_train.csv",
               [rows[i] for i in perm[n_test:]])
    _write_csv(kaggle_dir / "kaggle_art_dataset_test.csv",
               [rows[i] for i in perm[:n_test]])
    print("kaggle CSV splits written", flush=True)


def copy_test_images(kaggle_dir: Path, source_dir: Path) -> None:
    """Copy the test split's images into ``kaggle_dir/photos/test``
    (reference `get_kaggle_test.py`)."""
    dest = kaggle_dir / "photos" / "test"
    dest.mkdir(parents=True, exist_ok=True)
    with open(kaggle_dir / "kaggle_art_dataset_test.csv", newline="") as f:
        for row in csv.DictReader(f):
            shutil.copy(source_dir / row["filename"], dest / row["filename"])
    print(f"test images copied to {dest}", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="dataset download / preparation")
    p.add_argument("--sketchy_download", action="store_true")
    p.add_argument("--kaggle_split", action="store_true")
    p.add_argument("--kaggle_copy_test", type=str, default=None,
                   help="source image dir; copies the test split's images "
                        "(reference get_kaggle_test.py)")
    p.add_argument("--synthetic", action="store_true",
                   help="generate miniature synthetic corpora for smoke runs")
    p.add_argument("--learnable", action="store_true",
                   help="with --synthetic: render sketches as line drawings "
                        "of their paired photos (retrieval is learnable) "
                        "instead of unrelated noise")
    p.add_argument("--root", type=str, default="data")
    args = p.parse_args(argv)
    if args.learnable and not args.synthetic:
        p.error("--learnable only applies to --synthetic corpora")

    root = Path(args.root)
    if args.synthetic:
        from art_sbir_tpu_torch.data.synthetic import (make_synthetic_kaggle,
                                                       make_synthetic_sketchy)

        make_synthetic_sketchy(root / "sketchy", with_svg=True,
                               learnable=args.learnable)
        make_synthetic_kaggle(root / "kaggle")
        print(f"synthetic corpora written under {root}", flush=True)
        return

    if args.sketchy_download:
        sk = root / "sketchy"
        for name, url in SKETCHY_URLS.items():
            try:
                archive = download(url, sk / Path(url).name)
                if archive.suffix == ".zip":
                    unpack(archive, sk)
            except Exception as e:
                print(f"{name}: download failed ({e}); fetch it from {url} "
                      f"into {sk} by hand", flush=True)
    if args.kaggle_split:
        build_kaggle_split(root / "kaggle")
    if args.kaggle_copy_test:
        copy_test_images(root / "kaggle", Path(args.kaggle_copy_test))


if __name__ == "__main__":
    main()
