"""Model checkpoints as torch state dicts at ``models/<folder>.pt``.

The JAX package keeps orbax checkpoints (``core/checkpoint.py``); the
port saves and restores plain state dicts. Converting an orbax checkpoint
to ``.pt`` needs orbax and is still to port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

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
