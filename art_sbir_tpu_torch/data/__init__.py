"""Dataset layer: path/label catalogs with the reference's pairing and
split semantics, host-side decoding into fixed-shape uint8 batches, and
synthetic corpora for tests and smoke runs.

Counterpart of ``art_sbir_tpu/data/``. Importing the catalog modules
fills the :data:`DATASETS` registry: Sketchy (SketchyPix2Pix included),
Kaggle, Mixed and UnpairedDepth. The stroke catalogs (QuickDraw,
VectorizedSketchy) come with their slice; asking for one of them raises
the registry's "unknown dataset" error.
"""

from art_sbir_tpu_torch.data.catalog import DATASETS, get_datasets

# importing the dataset modules populates the DATASETS registry
from art_sbir_tpu_torch.data import kaggle as _kaggle  # noqa: F401,E402
from art_sbir_tpu_torch.data import mixed as _mixed  # noqa: F401,E402
from art_sbir_tpu_torch.data import sketchy as _sketchy  # noqa: F401,E402
from art_sbir_tpu_torch.data import unpaired as _unpaired  # noqa: F401,E402

__all__ = ["get_datasets", "DATASETS"]
