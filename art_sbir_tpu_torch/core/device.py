"""Device selection and float32 numerics for the port's entry points."""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def native_ieee_f32(x: torch.Tensor):
    """cuDNN off for the ops inside where ``x`` is a float32 CUDA tensor
    and TF32 is off (:func:`ieee_f32`): ATen's own CUDA convolutions
    (im2col and cuBLAS's IEEE SGEMM) and BatchNorm kernels run them, and
    the backward an op records follows its forward. On JAX's fresh inits
    cuDNN's float32 convolutions and BatchNorm left a pix2pix and a VAE
    step's gradients 2.5-4.3x the CPU's distance from float64, ATen's
    within it (PERF.md §6, PR 21). bf16 and TF32 work keeps cuDNN."""
    if (not x.is_cuda or x.dtype != torch.float32
            or torch.backends.cudnn.allow_tf32):
        yield
        return
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def card_fields(device: str | torch.device) -> dict:
    """``{"device_name", "power_limit"}`` of a CUDA device as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (a card may be set below its maximum power and then runs
    slower, so a time recorded on it names both); ``{}`` off the card."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    index = torch.cuda.current_device() if dev.index is None else dev.index
    line = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"device_name": name, "power_limit": limit}
