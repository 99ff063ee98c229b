"""Gallery and query embedding, and the gallery feature cache.

Counterpart of ``art_sbir_tpu/retrieval/embed.py``. The cache keeps the
reference's layout (reference ``utils.py:258-284``) and is byte-compatible
with the JAX package's: ``<root>/<model>_<dataset>_<ts>/image_paths.csv``
plus ``image_features.npy`` (float32), and the legacy
``image_features.csv`` on load.
"""

from __future__ import annotations

import concurrent.futures
import csv
from datetime import datetime
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from art_sbir_tpu_torch.core.device import resolve_device
from art_sbir_tpu_torch.parallel.mesh import split_batch


def embed_batched(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                  images: Callable[[int, int], np.ndarray] | np.ndarray,
                  n_images: Optional[int] = None, batch_size: int = 256,
                  device: str | torch.device | None = None,
                  feature_dim: Optional[int] = None,
                  return_device: bool = False, mesh=None):
    """Embed ``n_images`` in fixed-shape batches on ``device``.

    ``images`` is an (N, H, W, C) array or a loader ``(start, count) ->
    (count, H, W, C)``. The batch is a multiple of 32 no wider than the
    corpus needs; the tail batch is padded by repeating its first row.
    Host decode of batch i+1 overlaps the device work of batch i; the
    outputs stay on the device until one transfer at the end. Returns
    (N, D) float32 numpy, or the device tensor with ``return_device``.

    ``mesh`` (:class:`~art_sbir_tpu_torch.parallel.mesh.Mesh`): each
    batch is split over the mesh's distinct devices (:func:`~art_sbir_tpu_
    torch.parallel.mesh.split_batch`; a device that the mesh names several
    times, as the shards of one card, takes one part, which splitting
    would only cut into smaller launches), ``apply_fn`` gets each part on
    its own device (it picks its replica by the part's device), and the
    outputs come back to ``mesh.devices[0]``, which replaces ``device``.
    """
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    if not callable(images):
        arr = images
        n_images = arr.shape[0]
        images = lambda s, c: arr[s:s + c]  # noqa: E731
    if n_images is None:
        raise ValueError("n_images is required with a loader callable")
    batch_size = max(32, min(batch_size, -(-n_images // 32) * 32))

    def fetch(start: int) -> np.ndarray:
        count = min(batch_size, n_images - start)
        host = np.asarray(images(start, count))
        if count < batch_size:  # pad the tail to the fixed batch
            host = np.concatenate(
                [host, np.repeat(host[:1], batch_size - count, axis=0)])
        return host

    starts = list(range(0, n_images, batch_size))
    feats: List[torch.Tensor] = []
    with torch.no_grad(), concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(fetch, starts[0]) if starts else None
        for i in range(len(starts)):
            host = future.result()
            if i + 1 < len(starts):
                future = pool.submit(fetch, starts[i + 1])
            x = torch.from_numpy(host)
            parts = ([x.to(dev)] if mesh is None
                     else split_batch(x, mesh.distinct_devices()))
            outs = []
            for part in parts:
                out = apply_fn(part)
                if isinstance(out, (tuple, list)):  # classification models
                    out = out[0]
                outs.append(out.float().to(dev))
            feats.append(outs[0] if len(outs) == 1 else torch.cat(outs))
    if not feats:
        out = torch.zeros((0, feature_dim or 0), device=dev)
    else:
        out = torch.cat(feats)[:n_images]
    return out if return_device else out.cpu().numpy()


def save_image_features(model_name: str, dataset_name: str,
                        image_paths: Sequence[Path | str],
                        features: np.ndarray,
                        root: Path | str = Path("data/image_features"),
                        timestamp: Optional[str] = None) -> str:
    """Write the cache folder; returns its name."""
    ts = timestamp or datetime.now().strftime("%Y-%m-%d_%H-%M")
    folder = Path(root) / f"{model_name}_{dataset_name}_{ts}"
    folder.mkdir(parents=True, exist_ok=True)
    with open(folder / "image_paths.csv", "w") as f:
        csv.writer(f).writerows([[str(p)] for p in image_paths])
    np.save(folder / "image_features.npy", np.asarray(features, np.float32))
    return folder.name


def load_image_features(folder_name: str,
                        root: Path | str = Path("data/image_features")
                        ) -> Tuple[List[Path], np.ndarray]:
    """(paths, features) from a ``.npy`` cache or a reference-style
    ``image_features.csv``."""
    paths, feats = load_feature_cache(folder_name, root)
    return [Path(p) for p in paths], feats


def load_feature_cache(folder_name: str,
                       root: Path | str = Path("data/image_features")
                       ) -> Tuple[List[str], np.ndarray]:
    """:func:`load_image_features` with the paths as strings, as the
    engine and the ranking take them: a ``Path`` a row costs the host
    seconds at 10^6 rows."""
    folder = Path(root) / folder_name
    with open(folder / "image_paths.csv") as f:
        paths = [row[0] for row in csv.reader(f) if row]
    npy = folder / "image_features.npy"
    if npy.is_file():
        feats = np.load(npy)
    else:
        feats = np.atleast_2d(np.loadtxt(folder / "image_features.csv",
                                         delimiter=",", dtype=np.float64))
    return paths, feats
