"""Image decoding to fixed-shape uint8 arrays, and the gallery loader.

Counterpart of ``art_sbir_tpu/data/loader.py``: ``square`` is torchvision
``Resize((size, size))``, ``shortest_crop`` is ``Resize(size)`` then
``CenterCrop(size)``, both bicubic. Two decode backends give the same
pixels: the native C++ pipeline (:mod:`art_sbir_tpu_torch.data.native_loader`,
whole batches on a thread pool) and PIL, the reference implementation
(:func:`decode_image`), which also takes whatever the native decoder
rejects. PIL is imported inside the functions, only when an image is
decoded. :class:`TripletLoader` batches a catalog's triplets for
training, :class:`GalleryLoader` a gallery's images for embedding.
"""

from __future__ import annotations

import concurrent.futures
import io
import math
import random
import time
from pathlib import Path
from typing import BinaryIO, Dict, Iterator, List, Optional, Sequence, Tuple

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


def rank_rows(rows: List, rank: int, world: int) -> List:
    """Rank ``rank``'s share of a batch's rows, tiled first to
    ``lcm(len(rows), world)`` where ``world`` does not divide it."""
    reps = math.lcm(len(rows), world) // len(rows)
    tiled = list(rows) * reps
    per = len(tiled) // world
    return tiled[rank * per:(rank + 1) * per]


class TripletLoader:
    """Batches a RetrievalCatalog's triplets.

    Yields dicts of host numpy arrays: ``sketch``/``positive``/``negative``
    uint8 (B, S, S, 3), plus ``label``/``label2``/``augment`` int32 where
    the catalog gives them. Train mode shuffles each epoch with
    ``random.Random(seed)``, so the batch order is the JAX package's; one
    background thread builds batch k + 1 while the device works on batch
    k. A corrupt image falls back to item 0 with a note (reference
    `data_preparation.py:517-525`).

    ``shard`` = (rank, world): a data-parallel rank's rows. Every rank
    iterates the same seeded order and asks the catalog for every row (its
    negatives come from the catalog's generator); a batch of ``b`` rows
    that ``world`` does not divide is then tiled to ``lcm(b, world)`` rows
    (the JAX CLI's rule: tiling keeps the mean, the biased variance and
    the mean-loss gradient), and the rank decodes its contiguous share.
    """

    def __init__(self, catalog, batch_size: int = 32, image_size: int = 224,
                 resize_mode: Optional[str] = None,
                 shuffle: Optional[bool] = None, seed: int = 0,
                 prefetch: bool = True,
                 keys=("sketch", "positive", "negative"),
                 decode_backend: str = "auto",
                 shard: Optional[Tuple[int, int]] = None):
        self.catalog = catalog
        self.shard = shard
        self.batch_size = batch_size
        self.image_size = image_size
        # None -> the catalog family's geometry (RetrievalCatalog.resize_mode)
        self.resize_mode = resize_mode or getattr(catalog, "resize_mode",
                                                  "square")
        self.shuffle = (shuffle if shuffle is not None
                        else catalog.mode == "train")
        self.rng = random.Random(seed)
        self.prefetch = prefetch
        self.keys = keys
        self.decode_backend = decode_backend

    def __len__(self) -> int:
        return (len(self.catalog) + self.batch_size - 1) // self.batch_size

    def _decode(self, path) -> np.ndarray:
        try:
            return decode_image(path, self.image_size, self.resize_mode)
        except Exception as e:  # corrupt-image fallback (reference behavior)
            print(f"error decoding {path}: {e}", flush=True)
            fallback = self.catalog.item(0)
            key = self.keys[1] if self.keys[1] in fallback else self.keys[0]
            return decode_image(fallback[key], self.image_size,
                                self.resize_mode)

    def _decode_many(self, paths) -> np.ndarray:
        try:
            return decode_paths(paths, self.image_size, self.resize_mode,
                                backend=self.decode_backend)
        except Exception:
            # a corrupt file: decode this key image by image, so the
            # item-0 substitution applies to exactly the broken images
            return np.stack([self._decode(p) for p in paths])

    def _build(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        # every row's item, in order, on every rank: a catalog draws its
        # negatives from its own generator as items are asked for
        items = [self.catalog.item(i) for i in indices]
        if self.shard is not None:
            items = rank_rows(items, *self.shard)
        batch: Dict[str, np.ndarray] = {}
        for key in self.keys:
            if key in items[0]:
                batch[key] = self._decode_many([it[key] for it in items])
        for lk in ("label", "label2", "augment"):
            if lk in items[0]:
                batch[lk] = np.asarray([it[lk] for it in items], np.int32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order: List[int] = list(range(len(self.catalog)))
        if self.shuffle:
            self.rng.shuffle(order)
        chunks = [order[i:i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]
        if not self.prefetch:
            for c in chunks:
                yield self._build(c)
            return
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(self._build, chunks[0]) if chunks else None
            for i in range(len(chunks)):
                batch = future.result()
                future = (pool.submit(self._build, chunks[i + 1])
                          if i + 1 < len(chunks) else None)
                yield batch


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
