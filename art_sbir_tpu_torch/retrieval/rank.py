"""Ranking and retrieval metrics with the reference's contract.

Counterpart of ``art_sbir_tpu/retrieval/rank.py``. Replaces the
reference's per-sketch loop (one encoder call, one full pairwise
distance and one full sort per query, reference `inference.py:94-136`)
with query chunks on the device and metric assembly on the host:

* positive-index lookup: filename-stem rules (sketchy ``id-number``,
  kaggle ``id``, sketchit ``idx-id-random``, artworks full stem, reference
  `inference.py:33-38`) through an O(1) stem dictionary instead of a
  linear scan per query (reference `utils.py:22-25`);
* metrics: MRR, top-1..k accuracy, the rank distribution (the eight
  keys of pandas ``describe()``, computed with numpy) and 10 seeded
  retrieval samples (stdlib ``random``, seed 11, reference
  `inference.py:101-102`).
"""

from __future__ import annotations

import os
import random
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from art_sbir_tpu_torch.core.device import resolve_device
from art_sbir_tpu_torch.core.metrics import Timer
from art_sbir_tpu_torch.ops import retrieval_fused as rf
from art_sbir_tpu_torch.ops.distance import retrieve

# Gallery rows from which evaluate_retrieval and the serving engine stream
# queries through the fused kernel K1 instead of materializing a (Q, N)
# distance matrix. This is the JAX package's rule, located on a TPU v5e
# (the fused kernel never lost there from 50k rows up), kept as is so that
# both packages take the same route; chip_smoke.py's inference_k1 phase
# times both routes by gallery size on the H100 (PERF.md).
FUSED_GALLERY_THRESHOLD = 50_000


def sketch_stem_to_name(sketch_path: Path | str,
                        artworks_gallery: bool) -> Optional[str]:
    """Reference `inference.py:33-37` stem-parsing rules.

    Stems with 4+ dash-separated parts return ``None`` (a certain miss,
    rank = N): the reference leaves ``sketch_name`` as the un-joined
    ``re.split`` list there, which never equals a gallery stem in
    ``find_image_index`` (`utils.py:22-25`)."""
    stem = Path(sketch_path).stem
    parts = stem.split("-")
    if len(parts) <= 2:
        return stem if artworks_gallery else parts[0]
    if len(parts) == 3:
        return parts[1]
    return None


def path_stem(p: Path | str) -> str:
    """``Path(p).stem`` without building a ``Path`` (seconds for 10^6
    gallery paths): the last component less its last suffix, by pathlib's
    rule; a last component that pathlib would normalise ("", ".") goes
    through ``Path``."""
    s = os.fspath(p)
    name = s[s.rfind("/") + 1:]
    if name in ("", "."):
        return Path(s).stem
    i = name.rfind(".")
    return name[:i] if 0 < i < len(name) - 1 else name


def positive_indices(sketch_paths: Sequence[Path | str],
                     image_paths: Sequence[Path | str]) -> np.ndarray:
    """First gallery index whose stem matches each sketch's parsed name;
    -1 when missing (the reference records rank = N for those,
    `inference.py:39-41`)."""
    artworks = len(image_paths) > 0 and "artworks" in str(image_paths[0])
    stem_to_idx: Dict[str, int] = {}
    for i, p in enumerate(image_paths):
        stem_to_idx.setdefault(path_stem(p), i)  # first match wins
    names = [sketch_stem_to_name(p, artworks) for p in sketch_paths]
    return np.array([-1 if n is None else stem_to_idx.get(n, -1)
                     for n in names], dtype=np.int32)


def _describe(ranks_1based: np.ndarray) -> Dict[str, float]:
    """pandas ``describe()`` of the ranks (reference `inference.py:123-132`):
    count, mean, std (ddof 1), min, the 25/50/75% quantiles with linear
    interpolation, max; NaN where pandas gives NaN (no ranks, or std of
    one)."""
    x = np.asarray(ranks_1based, np.float64)
    n = x.size
    if n == 0:
        return {"count": 0.0, **{k: float("nan") for k in (
            "mean", "std", "min", "25%", "50%", "75%", "max")}}
    q25, q50, q75 = np.percentile(x, [25, 50, 75])
    return {"count": float(n), "mean": float(x.mean()),
            "std": float(x.std(ddof=1)) if n > 1 else float("nan"),
            "min": float(x.min()), "25%": float(q25), "50%": float(q50),
            "75%": float(q75), "max": float(x.max())}


def evaluate_retrieval(query_features, gallery_features,
                       sketch_paths: Sequence[Path | str],
                       image_paths: Sequence[Path | str],
                       loss_type: str = "euclidean", k: int = 10,
                       start_time: Optional[float] = None,
                       query_chunk: int = 1024, sample_seed: int = 11,
                       n_samples: int = 10, mesh=None,
                       device: str | torch.device | None = None,
                       trace: Optional[Dict] = None) -> Dict:
    """Full retrieval evaluation -> the reference's inference dict.

    ``query_features`` (Q, D) and ``gallery_features`` (N, D): numpy arrays
    or tensors. ``device``: where the ranking runs; by default the
    gallery tensor's device, else the card. Galleries of
    ``FUSED_GALLERY_THRESHOLD`` rows or more, with ``k`` <= 128 and a
    euclidean or cosine metric, stream through K1 with ranks
    (:func:`~art_sbir_tpu_torch.ops.retrieval_fused.retrieve_fused`,
    float32 operands); smaller ones take the exact route
    (:func:`~art_sbir_tpu_torch.ops.distance.retrieve`), one
    (chunk, N) distance matrix per ``query_chunk`` queries. Results stay on
    the device until one transfer after the last chunk; K1's per-row
    certificate is the only read before that.

    ``mesh`` (:class:`~art_sbir_tpu_torch.parallel.mesh.Mesh`): where K1
    runs, the mesh's S > 1 devices divide N and k is at most N / S, the
    gallery is sharded by rows over them and each query chunk runs the
    sharded sweep (:func:`~art_sbir_tpu_torch.ops.retrieval_fused.
    retrieve_fused_sharded`: one K1 launch a card for its shards, an
    O(Q k) merge on ``mesh.devices[0]`` over several cards); otherwise the unsharded route runs, as in the
    JAX package (which raises where k > N / S instead). ``device``
    defaults to ``mesh.devices[0]`` then.

    ``trace``: a dict that receives the ``route`` taken (``"K1"``,
    ``"K1_sharded"`` or ``"exact"``), the per-query ``ranks`` as scored
    (0-based, a miss at N), the top-k ``values`` and ``indices`` as
    reported, and ``rank_s``, the wall time up to the transfer."""
    timer = Timer()
    if device is None and mesh is not None:
        device = mesh.devices[0]
    if device is None and isinstance(gallery_features, torch.Tensor):
        device = gallery_features.device
    dev = resolve_device(device)
    n_gallery = len(image_paths)
    pos = positive_indices(sketch_paths, image_paths)
    missing = pos < 0
    pos_t = torch.as_tensor(np.where(missing, 0, pos), device=dev)

    gal = torch.as_tensor(gallery_features).to(dev, torch.float32).contiguous()
    queries = torch.as_tensor(query_features).to(dev, torch.float32)
    k_eff = min(k, n_gallery)  # tiny-gallery clamp; metrics still report k
    use_fused = (loss_type in ("euclidean", "cosine")
                 and n_gallery >= FUSED_GALLERY_THRESHOLD
                 and k_eff <= rf.K_MAX)
    # the sharded sweep splits the gallery over the mesh's one axis; each
    # shard's top-k holds k of its own rows
    n_shards = 0 if mesh is None else mesh.size
    sharded = (use_fused and n_shards > 1 and n_gallery % n_shards == 0
               and k_eff <= n_gallery // n_shards)
    gg = rf.gallery_norms(gal, loss_type) if use_fused else None
    if sharded:  # the shards and their norms, placed once for every chunk
        gal, gg = rf.shard_gallery(gal, mesh, gg, loss_type)
    rs, vs, idxs = [], [], []
    with torch.no_grad():
        for s in range(0, len(sketch_paths), query_chunk):
            q = queries[s:s + query_chunk].contiguous()
            p = pos_t[s:s + query_chunk]
            if use_fused:
                if sharded:
                    r, v, i = rf.retrieve_fused_sharded(
                        q, gal, p, mesh, k=k_eff, metric=loss_type, gg=gg)
                else:
                    r, v, i = rf.retrieve_fused(q, gal, p, k=k_eff,
                                                metric=loss_type, gg=gg)
                # K1 reports squared eps-folded distances (euclidean) or
                # cosine distances
                if loss_type == "euclidean":
                    v = torch.sqrt(v)
            else:
                r, v, i = retrieve(q, gal, p, k=k_eff, metric=loss_type)
            rs.append(r)
            vs.append(v)
            idxs.append(i)

    if rs:
        ranks = torch.cat(rs).cpu().numpy().astype(np.int64)
        topk_val = torch.cat(vs).cpu().numpy().astype(np.float32)
        topk_idx = torch.cat(idxs).cpu().numpy().astype(np.int64)
    else:
        ranks = np.zeros(0, np.int64)
        topk_val = np.zeros((0, k_eff), np.float32)
        topk_idx = np.zeros((0, k_eff), np.int64)
    rank_s = timer.elapsed()

    ranks[missing] = n_gallery  # the reference returns len(image_paths)
    if trace is not None:
        route = ("K1_sharded" if sharded else "K1") if use_fused else "exact"
        trace.update(route=route, ranks=ranks,
                     values=topk_val, indices=topk_idx, rank_s=rank_s)
    ranks1 = ranks + 1
    mrr = float(np.mean(1.0 / ranks1))
    topk_acc = [float(np.mean(ranks <= j)) for j in range(k)]

    # seeded retrieval samples: the reference's RNG (inference.py:100-102,120)
    rng = random.Random()
    rng.seed(sample_seed)
    picks = [rng.randrange(0, len(sketch_paths)) for _ in range(n_samples)]
    samples = []
    for i in sorted(set(picks)):
        entries = [(str(image_paths[int(gi)]), float(gv))
                   for gi, gv in zip(topk_idx[i], topk_val[i])]
        samples.append({str(sketch_paths[i]): entries})

    elapsed = timer.elapsed() + (start_time or 0.0)
    stats: Dict = {"mean_reciprocal_rank": mrr, "size": n_gallery,
                   "inference_time": elapsed}
    stats.update(_describe(ranks1))
    stats["topk_acc"] = topk_acc
    stats["retrieval_samples"] = samples
    return stats
