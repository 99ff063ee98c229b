"""Model exports as torch state dicts at ``models/<folder>.pt``, and
epoch-tagged resumable training checkpoints.

Counterpart of ``art_sbir_tpu/core/checkpoint.py``. The JAX package keeps
orbax checkpoints; the port saves and restores plain state dicts.
Converting an orbax checkpoint to ``.pt`` needs orbax and is still to
port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import torch


def checkpoint_path(models_root: Path | str, folder: str) -> Path:
    return Path(models_root) / f"{folder}.pt"


def save_state_dict(path: Path | str, state_dict: Dict[str, torch.Tensor]
                    ) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load_state_dict(path: Path | str) -> Dict[str, torch.Tensor]:
    """Tensors only (``weights_only=True``), on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """Epoch-tagged checkpoints ``<directory>/<step>.pt``, the newest
    ``max_to_keep`` kept. Each holds a dict of tensors and plain values
    (the model's state dict, the optimizer's, the step), so it loads with
    ``weights_only=True``."""

    def __init__(self, directory: Path | str, max_to_keep: int = 3):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list:
        return sorted(int(p.stem) for p in self._dir.glob("*.pt")
                      if p.stem.isdigit())

    def save(self, step: int, state: Dict[str, Any]) -> Path:
        path = self._dir / f"{step}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save(state, tmp)
        tmp.replace(path)  # a reader never sees half a file
        for old in self.steps()[:-self.max_to_keep]:
            (self._dir / f"{old}.pt").unlink()
        return path

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The checkpoint of ``step`` (default: the latest), on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        return torch.load(self._dir / f"{step}.pt", map_location="cpu",
                          weights_only=True)
