"""Image decoding to fixed-shape uint8 arrays (PIL).

Counterpart of ``art_sbir_tpu/data/loader.py``'s PIL path: ``square`` is
torchvision ``Resize((size, size))``, ``shortest_crop`` is ``Resize(size)``
then ``CenterCrop(size)``, both bicubic. The native C++ decoder
(bit-identical to PIL) comes with a later slice. PIL is imported here,
inside the functions, only when an image is decoded.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import BinaryIO

import numpy as np

from art_sbir_tpu_torch.ops.resize import center_crop_slices, shortest_side_size

# the Kaggle corpus holds one 283-megapixel scan (reference
# data_preparation.py:489); PIL's decompression-bomb guard stays above it
MAX_IMAGE_PIXELS = 283_327_980


def decode_image(path: Path | str | BinaryIO, size: int,
                 resize_mode: str = "square",
                 grayscale: bool = False) -> np.ndarray:
    """PIL decode -> uint8 (size, size, 3), or (size, size, 1) grayscale."""
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = max(Image.MAX_IMAGE_PIXELS or 0, MAX_IMAGE_PIXELS)
    img = Image.open(path)
    img = img.convert("L" if grayscale else "RGB")
    if resize_mode == "square":
        img = img.resize((size, size), Image.BICUBIC)
    elif resize_mode == "shortest_crop":
        nh, nw = shortest_side_size(img.height, img.width, size)
        img = img.resize((nw, nh), Image.BICUBIC)
        top, left = center_crop_slices(nh, nw, size)
        img = img.crop((left, top, left + size, top + size))
    else:
        raise ValueError(f"unknown resize_mode {resize_mode}")
    arr = np.asarray(img, np.uint8)
    if grayscale:
        arr = arr[..., None]
    return arr


def decode_bytes(data: bytes, size: int, resize_mode: str = "square",
                 grayscale: bool = False) -> np.ndarray:
    """Decode ONE in-memory image (an HTTP request body) -> uint8
    (size, size, C)."""
    return decode_image(io.BytesIO(data), size, resize_mode, grayscale)
