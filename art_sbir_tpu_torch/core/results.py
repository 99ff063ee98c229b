"""Results-directory contract.

Counterpart of ``art_sbir_tpu/core/results.py``: a run folder
``results/<Class>_<dataset>_<YYYY-MM-DD_HH-MM>/`` holds
``data_params.json``, ``training.json``, ``training_params.json`` and
``inference.json`` (reference ``utils.py:210-254``); the model export
lands beside it as ``models/<run>.pt``."""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional

RESULT_FILES = ("data_params", "training", "training_params", "inference")


def _jsonable(obj: Any) -> Any:
    """numpy and torch scalars and arrays, paths and containers -> json."""
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    return obj


class ResultsWriter:
    """Creates and fills one ``<root>/<run_name>`` directory."""

    def __init__(self, model_class: str, dataset: str,
                 root: Path | str = Path("results"),
                 timestamp: Optional[str] = None):
        ts = timestamp or datetime.now().strftime("%Y-%m-%d_%H-%M")
        self.run_name = f"{model_class}_{dataset}_{ts}"
        self.path = Path(root) / self.run_name
        self.path.mkdir(parents=True, exist_ok=True)

    def write(self, name: str, payload: Dict[str, Any]) -> Path:
        out = self.path / f"{name}.json"
        out.write_text(json.dumps(_jsonable(payload), indent=4))
        return out

    def write_all(self, data_params: Dict[str, Any], training: Dict[str, Any],
                  training_params: Dict[str, Any],
                  inference: Dict[str, Any]) -> Path:
        for name, payload in zip(RESULT_FILES, (data_params, training,
                                                training_params, inference)):
            self.write(name, payload)
        return self.path


def load_results(folder: Path | str) -> Dict[str, Dict[str, Any]]:
    """The run's JSON files that exist, by name; missing ones are absent."""
    folder = Path(folder)
    out = {}
    for name in RESULT_FILES:
        f = folder / f"{name}.json"
        if f.is_file():
            out[name] = json.loads(f.read_text())
    return out
