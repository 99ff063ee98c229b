"""Vectorized Sketchy: SVG sketches as stroke-5 sequences with JSON caching
(reference `data_preparation.py:229-336`).

Counterpart of ``art_sbir_tpu/data/vector_sketchy.py``. The first run
parses every SVG with :func:`art_sbir_tpu_torch.ops.svg.parse_svg`
(reduce_factor=2, max_length=100) into ``sketch_vectors_100_2_V2/<class>/
<stem>.json``; later runs load the cache. Sequences are purified (length
(10, max], deltas clipped ±1000) and normalized by the global delta std.
Per item the catalog serves the padded (100, 5) stroke tensor + length;
the paired 'photo' (``img_format == 'svg'``) is rasterized a batch at a
time on the device, from the float64 host points cached here.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from art_sbir_tpu_torch.data import strokes as S
from art_sbir_tpu_torch.data.catalog import DATASETS
from art_sbir_tpu_torch.data.sketchy import SketchyCatalogV1
from art_sbir_tpu_torch.ops import svg as svg_ops
from art_sbir_tpu_torch.ops.rasterize import prepare_points_host


class VectorizedSketchyCatalogV1(SketchyCatalogV1):
    name = "VectorizedSketchyDatasetV1"

    def __init__(
        self,
        sketch_format="svg",
        img_format="jpg",
        img_type="photos",
        mode="train",
        split_ratio=0.1,
        size=1.0,
        seed=42,
        max_erase_count=99999,
        only_valid=True,
        root: Optional[Path] = None,
        reduce_factor: int = 2,
        maximum_length: int = 100,
        **_,
    ):
        super().__init__(
            sketch_format, img_format, img_type, mode, split_ratio, size, seed,
            max_erase_count, only_valid, root=root, do_split=False,
        )
        self.reduce_factor = reduce_factor
        self.maximum_length = maximum_length
        self.vector_path = (
            self.path / f"sketch_vectors_{maximum_length}_{reduce_factor}_V2"
        )

        vectorized = []
        if not self.vector_path.is_dir():
            for p in self.sketch_paths:
                out_dir = self.vector_path / p.parent.name
                out_dir.mkdir(parents=True, exist_ok=True)
                vectorized.append(
                    svg_ops.parse_svg(p, out_dir, reduce_factor, maximum_length)
                )
        else:
            for p in self.sketch_paths:
                vectorized.append(
                    svg_ops.load_vector_sketch(
                        self.vector_path / p.parent.name / f"{p.stem}.json"
                    )
                )

        self.sketch_paths, self.photo_paths, self.vectorized = self._sample_split(
            [self.sketch_paths, self.photo_paths, vectorized]
        )

        lengths = [len(v["image"]) for v in self.vectorized]
        self.avg_seq_len = float(np.round(np.mean(lengths) + np.std(lengths)))
        self.max_seq_len = int(np.max(lengths))
        self.min_seq_len = int(np.min(lengths))

        seqs = [np.asarray(v["image"], np.float32) for v in self.vectorized]
        kept, idx = S.purify(seqs, self.max_seq_len)
        self.sketch_paths = [self.sketch_paths[i] for i in idx]
        self.photo_paths = [self.photo_paths[i] for i in idx]
        self.vectorized = [self.vectorized[i] for i in idx]
        kept = S.normalize(kept)
        for v, seq in zip(self.vectorized, kept):
            v["image"] = seq
        # the 256x256 delta reshape is deterministic per sketch — cache the
        # padded tensor once instead of recomputing on every epoch access
        self._padded_cache: Dict[int, np.ndarray] = {}

    def item(self, idx: int) -> Dict:
        """(length, padded stroke-5). The 256x256 reshape of deltas is
        applied here (reference `data_preparation.py:283`); the raster
        'photo' is produced on device when img_format == 'svg', else the
        CLI decodes the real photo path."""
        v = self.vectorized[idx]
        cached = self._padded_cache.get(idx)
        if cached is None:
            reshaped = svg_ops.reshape_vector_sketch(v)["image"]
            padded = S.padded5_with_final_end(reshaped, self.maximum_length)
            extras = {}
            if self.img_format == "svg":
                # the float64 host canvas points for the device
                # rasterizer (ops/rasterize.py::prepare_points_host)
                pts, segs = prepare_points_host(padded[None])
                extras = {"raster_points": pts[0], "raster_segs": segs[0]}
            cached = (padded, extras)
            self._padded_cache[idx] = cached
        padded, extras = cached
        out = {
            "length": len(v["image"]),
            "sketch_vector": padded,
            **extras,
        }
        if self.img_format != "svg":
            out["photo_path"] = self.photo_paths[idx]
        return out

    @property
    def state_dict(self) -> Dict:
        d = super().state_dict
        d["sequence_stats"] = {
            "max_seq_len": self.max_seq_len,
            "min_seq_len": self.min_seq_len,
            "avg_seq_len": int(self.avg_seq_len),
        }
        d["reduce_factor"] = self.reduce_factor
        d["maximum_length"] = self.maximum_length
        d["V2"] = True
        return d


def _vectorized(mode="train", **kw):
    return VectorizedSketchyCatalogV1(
        sketch_format="svg",
        img_format=kw.get("img_format", "jpg"),
        img_type=kw.get("img_type", "photos"),
        mode=mode,
        split_ratio=kw.get("split_ratio", 0.1),
        size=kw.get("size", 1.0),
        seed=kw.get("seed", 42),
        max_erase_count=kw.get("max_erase_count", 99999),
        only_valid=kw.get("only_valid", True),
        root=kw.get("root"),
    )


DATASETS.register("VectorizedSketchyV1", _vectorized)
