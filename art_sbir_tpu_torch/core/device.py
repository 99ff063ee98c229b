"""Device selection and float32 numerics for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. A CUDA device without CUDA raises: an entry
    point never carries on on the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' (or --device cpu) to run on the CPU")
    return dev


def ieee_f32() -> None:
    """``precision='highest'``: IEEE float32 matmuls and convolutions.
    cuDNN runs float32 convolutions in TF32 by default (about three
    decimal digits), so both switches are set off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
