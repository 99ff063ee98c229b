"""QuickDraw stroke dataset (reference `data_preparation.py:375-462`).

Loads per-category ``.npz`` stroke-3 archives (6 default categories), takes
the first ``size * n`` sketches, purifies + sketch-rnn-normalizes, and
serves padded stroke-5 tensors. Counterpart of
``art_sbir_tpu/data/quickdraw.py``. The paired 'photo' is rasterized on
the device (:func:`art_sbir_tpu_torch.ops.rasterize.rasterize_strokes`),
not in ``__getitem__``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from art_sbir_tpu_torch.data import strokes as S
from art_sbir_tpu_torch.data.catalog import DATASETS

CATEGORIES = ["baseball bat", "banana", "apple", "ant", "alarm clock", "airplane"]


class QuickDrawCatalogV1:
    name = "QuickDrawDatasetV1"

    def __init__(self, mode="train", size=0.1, max_length=100,
                 root: Optional[Path] = None, categories=None, **_):
        self.mode, self.size = mode, size
        self.maximum_length = max_length
        self.path = Path(root) if root else Path("data/quick_draw")
        self.categories = categories or CATEGORIES

        seqs: List[np.ndarray] = []
        split = "train" if mode == "train" else "valid"
        for cat in self.categories:
            data = np.load(self.path / f"{cat}.npz", encoding="latin1",
                           allow_pickle=True)
            seqs.extend(list(data[split]))
        seqs = seqs[: int(self.size * len(seqs))]

        lengths = [len(s) for s in seqs]
        self.avg_seq_len = int(np.round(np.mean(lengths) + np.std(lengths)))
        self.max_seq_len = int(np.max(lengths))
        self.min_seq_len = int(np.min(lengths))

        kept, _ = S.purify(seqs, self.max_seq_len)
        self.sketches = S.normalize(kept)

    def __len__(self):
        return len(self.sketches)

    def item(self, idx: int) -> Dict:
        """Padded stroke-5 + true length; the device pipeline rasterizes
        ``sketch_vector`` into the ImageNet-normalized 'photo'."""
        s3 = self.sketches[idx]
        return {
            "length": len(s3),
            "sketch_vector": S.stroke3_to_padded5(s3, self.maximum_length),
        }

    @property
    def state_dict(self) -> Dict:
        return {
            "dataset": self.name,
            "size": self.size,
            "img_number": len(self),
            "mode": self.mode,
            "maximum_length": self.maximum_length,
            "sequence_stats": {
                "max_seq_len": self.max_seq_len,
                "min_seq_len": self.min_seq_len,
                "avg_seq_len": self.avg_seq_len,
            },
        }


def _quickdraw(mode="train", **kw):
    return QuickDrawCatalogV1(mode=mode, size=kw.get("size", 0.1),
                              root=kw.get("root"))


DATASETS.register("QuickdrawV1", _quickdraw)
