"""Image decoding to fixed-shape uint8 arrays, and the gallery loader.

Counterpart of ``art_sbir_tpu/data/loader.py``: ``square`` is torchvision
``Resize((size, size))``, ``shortest_crop`` is ``Resize(size)`` then
``CenterCrop(size)``, both bicubic. Two decode backends give the same
pixels: the native C++ pipeline (:mod:`art_sbir_tpu_torch.data.native_loader`,
whole batches on a thread pool) and PIL, the reference implementation
(:func:`decode_image`), which also takes whatever the native decoder
rejects. PIL is imported inside the functions, only when an image is
decoded. The triplet loader comes with the training slice.
"""

from __future__ import annotations

import io
import time
from pathlib import Path
from typing import BinaryIO, Sequence

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


def decode_paths(paths: Sequence[Path | str], size: int,
                 resize_mode: str = "square", grayscale: bool = False,
                 backend: str = "auto") -> np.ndarray:
    """Decode ``paths`` into one (N, size, size, C) uint8 batch.

    ``backend``: ``"native"`` requires the C++ pipeline, ``"pil"`` decodes
    image by image with PIL, ``"auto"`` takes native when the library
    builds and loads and PIL otherwise. Images the native decoder rejects
    are decoded with PIL one by one; a PIL failure there reaches the
    caller. Both backends give bit-identical pixels."""
    if backend not in ("auto", "native", "pil"):
        raise ValueError(f"unknown decode backend {backend}")
    if backend != "pil":
        from art_sbir_tpu_torch.data import native_loader

        if native_loader.available():
            batch, failed = native_loader.decode_batch(
                paths, size, resize_mode, grayscale=grayscale)
            for i in failed:
                batch[i] = decode_image(paths[i], size, resize_mode, grayscale)
            return batch
        if backend == "native":
            raise native_loader.NativeUnavailable(
                "native decode requested but libimgpipe is unavailable")
    ch = 1 if grayscale else 3
    out = np.empty((len(paths), size, size, ch), np.uint8)
    for i, p in enumerate(paths):
        out[i] = decode_image(p, size, resize_mode, grayscale)
    return out


class GalleryLoader:
    """Feeds :func:`art_sbir_tpu_torch.retrieval.embed.embed_batched`: a
    ``(start, count) -> (count, S, S, 3)`` view over dedup-sorted paths.
    ``decode_s``: the wall time its calls have spent decoding."""

    def __init__(self, image_paths, image_size: int = 224,
                 resize_mode: str = "square", decode_backend: str = "auto"):
        self.image_paths = list(image_paths)
        self.image_size = image_size
        self.resize_mode = resize_mode
        self.decode_backend = decode_backend
        self.decode_s = 0.0

    def __len__(self):
        return len(self.image_paths)

    def __call__(self, start: int, count: int) -> np.ndarray:
        t = time.perf_counter()
        out = decode_paths(self.image_paths[start:start + count],
                           self.image_size, self.resize_mode,
                           backend=self.decode_backend)
        self.decode_s += time.perf_counter() - t
        return out
