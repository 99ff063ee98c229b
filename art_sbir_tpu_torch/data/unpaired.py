"""Unpaired image catalog for the informative-drawings pipeline.

Counterpart of ``art_sbir_tpu/data/unpaired.py`` and of the reference
``UnpairedDepthDataset`` (`drawing_utils/dataset.py:43-150`): a recursive
image glob capped at 10k files (`dataset.py:29-41`), optional per-image
midas depth maps, and in train mode an unpaired second domain aligned by
index after the reference's repeat-and-cutoff balancing. Decoding and
resizing run in the shared loader.

Reference semantics reproduced (with two deliberate, documented deviations):

* depth mode (`dataset.py:52-75`): the image list is REBUILT from the depth
  maps — for each depth map, keep the image in ``root`` whose basename
  matches, else ``<stem>.jpg``; images without a depth correspondence are
  dropped. DEVIATION: the reference keeps the FULL depth list
  (`dataset.py:77` ``self.depth_maps = depth``), so when any depth map lacks
  an image correspondence, ``depth_maps[i]`` / ``data[i]`` pairing SHIFTS
  for every later index — a misalignment bug. This catalog keeps only the
  matched maps (``kept_depth``) so the pairing is always correct.
* file listing: the reference's ``make_dataset`` accepts jpg/jpeg/png only
  and walks ``sorted(os.walk)`` with UNSORTED filenames within a directory;
  :func:`list_images` deliberately widens to bmp/webp (any case) and uses a
  fully ``sorted`` recursive glob so which files survive the 10k cap is
  deterministic across filesystems.
* train second domain (`dataset.py:87-105`): the shorter of (data, img2) is
  tiled ``(len(longer) // len(shorter)) + 1`` times, then both truncated to
  ``min`` of the new lengths — i.e. the shorter list cycles; pairing is by
  index, not random.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

from art_sbir_tpu_torch.data.catalog import DATASETS

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
MAX_FILES = 10_000


def list_images(root: Path | str, max_files: int = MAX_FILES) -> List[Path]:
    """Sorted recursive glob capped at ``max_files`` (reference
    `drawing_utils/base_dataset.py` ``make_dataset``, cap at
    `dataset.py:29-41`)."""
    root = Path(root)
    out: List[Path] = []
    for p in sorted(root.rglob("*")):
        if p.suffix.lower() in _EXTS and p.is_file():
            out.append(p)
            if len(out) >= max_files:
                break
    return out


class UnpairedImageCatalog:
    name = "UnpairedDepthDataset"
    resize_mode = "square"

    def __init__(
        self,
        root: Path | str,
        root2: Optional[Path | str] = None,
        depth_root: Optional[Path | str] = None,
        mode: str = "train",
    ):
        self.mode = mode
        self.paths = list_images(root)
        self.depth_maps: List[Path] = []

        if depth_root:
            # rebuild the image list from depth correspondences
            # (reference dataset.py:52-75)
            root = Path(root)
            depth = list_images(depth_root)
            newimages: List[Path] = []
            kept_depth: List[Path] = []
            for dmap in depth:
                cand1 = root / dmap.name
                cand2 = root / f"{dmap.stem.split('.')[0]}.jpg"
                if cand1.exists():
                    newimages.append(cand1)
                    kept_depth.append(dmap)
                elif cand2.exists():
                    newimages.append(cand2)
                    kept_depth.append(dmap)
            self.paths = newimages
            self.depth_maps = kept_depth

        self.paths2: List[Path] = []
        if mode == "train" and root2:
            img2 = list_images(root2)
            data, dmaps = self.paths, self.depth_maps
            if img2 and len(data) > len(img2):
                img2 = img2 * (len(data) // len(img2) + 1)
            elif img2 and len(img2) > len(data):
                reps = len(img2) // len(data) + 1
                data = data * reps
                dmaps = dmaps * reps
            cutoff = min(len(data), len(img2)) if img2 else len(data)
            self.paths = data[:cutoff]
            self.depth_maps = dmaps[:cutoff] if dmaps else []
            self.paths2 = img2[:cutoff]

    def __len__(self) -> int:
        return len(self.paths)

    def item(self, idx: int) -> Dict:
        out: Dict = {
            "image": self.paths[idx],
            "name": self.paths[idx].stem,
            "index": idx,
        }
        if self.mode == "train" and self.paths2:
            out["image2"] = self.paths2[idx]  # index-aligned, cycled domain
        if self.depth_maps:
            out["depth"] = self.depth_maps[idx]
        return out

    @property
    def state_dict(self) -> Dict:
        return {
            "dataset": self.name,
            "img_number": len(self),
            "mode": self.mode,
            "second_domain": bool(self.paths2),
            "with_depth": bool(self.depth_maps),
        }


@DATASETS.register("UnpairedDepth")
def _unpaired_factory(mode: str = "train", root=None, root2=None,
                      depth_root=None, **_unused):
    """Factory adapter: ``get_datasets('UnpairedDepth', root=..., `` —
    the reference constructs this dataset directly in `create_drawings.py:78`
    rather than via its factory; registering it gives one uniform dataset
    surface."""
    return UnpairedImageCatalog(root=root or "data/kaggle/images",
                                root2=root2, depth_root=depth_root, mode=mode)
