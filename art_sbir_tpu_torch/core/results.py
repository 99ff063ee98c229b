"""Results-directory contract (reader side).

Counterpart of ``art_sbir_tpu/core/results.py::load_results``: a run
folder ``results/<Class>_<dataset>_<ts>/`` holds ``data_params.json``,
``training.json``, ``training_params.json`` and ``inference.json``
(reference ``utils.py:210-254``)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

RESULT_FILES = ("data_params", "training", "training_params", "inference")


def load_results(folder: Path | str) -> Dict[str, Dict[str, Any]]:
    """The run's JSON files that exist, by name; missing ones are absent."""
    folder = Path(folder)
    out = {}
    for name in RESULT_FILES:
        f = folder / f"{name}.json"
        if f.is_file():
            out[name] = json.loads(f.read_text())
    return out
