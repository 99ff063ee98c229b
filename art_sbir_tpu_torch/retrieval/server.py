"""Serving engine: a resident gallery and micro-batched queries.

Counterpart of ``art_sbir_tpu/retrieval/server.py``: the exact route, the
K1 route, the int8 route, the IVF and IVF-PQ routes, capacity mode and the
row-sharded gallery.

* **Batch buckets.** Query batches are padded to powers of two up to
  ``max_batch`` and the pad rows' results are dropped.
* **Micro-batching.** :class:`MicroBatcher` coalesces concurrent requests
  into one :meth:`RetrievalEngine.search_arrays` call.
* **Routes.** An immutable gallery of at least
  ``rank.FUSED_GALLERY_THRESHOLD`` rows streams each batch through the
  fused kernel K1 (:mod:`art_sbir_tpu_torch.ops.retrieval_fused`); smaller
  and capacity galleries take the exact route: ``pairwise_distance`` then
  ``top_k`` under the live-row mask. ``quantize=True`` replaces both with
  the int8 candidate scan and an exact rerank
  (:mod:`art_sbir_tpu_torch.ops.quant`): through K2 wherever it runs (on
  the card, D a multiple of 16, and at most ``quant_fused.ENGINE_R_MAX`` =
  1,024 candidates, where K2's route beat the plain scan's on an H100),
  else the plain scan. ``ivf_nlist`` replaces every scan with the IVF
  probe (:mod:`art_sbir_tpu_torch.ops.ivf`, route ``'ivf'``), and
  ``pq_m`` with the IVF-PQ probe (:mod:`art_sbir_tpu_torch.ops.pq`, route
  ``'ivf_pq'``); both are plain PyTorch (the JAX package has no Pallas
  kernel on them). The engine's ``route`` attribute names the route it
  took.
* **Online updates** (``capacity=``): the gallery is a fixed-capacity
  buffer with a live-row mask. Adds and removals build a new
  (gallery, mask) pair, and an online IVF new table and spill tensors,
  and publish them under the engine lock, so a search running on another
  thread keeps the consistent state it took.
* **Row-sharded gallery** (``mesh=``): shard ``i`` of the rows (or of the
  capacity) lives on ``mesh.devices[i]``. Each route ranks each shard on
  its own device and merges the (B, k) partials by (value, global index)
  on ``mesh.devices[0]``, where the queries are embedded: K1 through
  :func:`~art_sbir_tpu_torch.ops.retrieval_fused.retrieve_fused_sharded`,
  the int8 route through :func:`~art_sbir_tpu_torch.ops.quant.
  retrieve_quantized_sharded`, the IVF routes through
  :func:`~art_sbir_tpu_torch.ops.ivf.ivf_search_sharded` and
  :func:`~art_sbir_tpu_torch.ops.pq.ivf_pq_search_sharded`, the exact
  route per shard under its live mask. Slot ``s`` of a capacity engine is
  row ``s % (rows / S)`` of shard ``s // (rows / S)``.
* **One device thread.** The HTTP server runs the device work of every
  endpoint on the micro-batcher's thread (:meth:`MicroBatcher.call`).
  PyTorch keeps cuDNN's execution plans and the CUDA library handles per
  thread, so the first dispatch on a fresh thread, such as a new handler
  thread per connection, pays their set-up again (about 0.1 s at full
  width on an H100, PERF.md).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from art_sbir_tpu_torch.core.device import resolve_device
from art_sbir_tpu_torch.data.loader import decode_bytes
from art_sbir_tpu_torch.ops import ivf as ivf_ops
from art_sbir_tpu_torch.ops import pq as pq_ops
from art_sbir_tpu_torch.ops import quant_fused
from art_sbir_tpu_torch.ops.distance import pairwise_distance, top_k
from art_sbir_tpu_torch.ops.quant import (quantize_gallery,
                                          retrieve_quantized,
                                          retrieve_quantized_fused,
                                          retrieve_quantized_sharded,
                                          shard_quant_gallery)
from art_sbir_tpu_torch.ops.retrieval_fused import (K_MAX, gallery_norms,
                                                    retrieve_fused,
                                                    retrieve_fused_sharded,
                                                    shard_gallery)
from art_sbir_tpu_torch.ops.sharded import gather_to, lexsort_topk_merge
from art_sbir_tpu_torch.parallel.mesh import shard_rows
from art_sbir_tpu_torch.retrieval import rank
from art_sbir_tpu_torch.retrieval.embed import (load_image_features,
                                                save_image_features)


def _buckets(max_batch: int) -> List[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


@dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    batched_requests: int = 0  # requests that shared a dispatch
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, batch_size: int) -> None:
        with self.lock:
            self.requests += batch_size
            self.batches += 1
            if batch_size > 1:
                self.batched_requests += batch_size

    def snapshot(self) -> Dict[str, float]:
        with self.lock:
            return {
                "requests": self.requests,
                "batches": self.batches,
                "batched_requests": self.batched_requests,
                "mean_batch": (self.requests / self.batches
                               if self.batches else 0.0),
            }


class RetrievalEngine:
    """Owns the resident gallery.

    ``forward_fn``: uint8 (B, S, S, 3) tensor on ``device`` -> (B, D)
    embeddings (or a tuple whose first item they are), preprocessing
    inside. ``query_forward_fn`` (optional) embeds search queries instead:
    a per-modality-BN run passes an encoder with sketch-population running
    stats here while the gallery and ``/add`` rows keep ``forward_fn``.
    ``capacity``: enable online :meth:`add_images` / :meth:`remove`.
    ``quantize``: int8 candidate scan + exact rerank over an immutable
    gallery; ``rerank_factor * k_max`` candidates per query, re-ranked on
    rows kept resident in ``rerank_dtype`` (``'bfloat16'`` halves them, at
    bf16 rounding of the reported distances; candidate selection and the
    rerank arithmetic are unchanged).
    ``device``: the card unless ``'cpu'`` is passed. ``mesh``: serve the
    gallery row-sharded over ``mesh.devices`` (see the module note; the
    rows, or ``capacity``, divisible by the mesh's size, ``k_max`` at most
    a shard's rows); ``device`` is then ``mesh.devices[0]``.

    ``ivf_nlist``: build an IVF index at startup (0: about 2*sqrt(N)
    clusters) and answer by probing the ``ivf_nprobe`` nearest clusters
    (0: auto-tuned at startup, the smallest power of two reaching 95%
    recall@k_max on a perturbed-gallery proxy, doubled). Composes with
    ``capacity`` (:class:`~art_sbir_tpu_torch.ops.ivf.OnlineIVF`; the
    initial gallery must be non-empty) and with ``mesh``
    (:class:`~art_sbir_tpu_torch.ops.ivf.ShardedIVF`, or with ``capacity``
    too :class:`~art_sbir_tpu_torch.ops.ivf.ShardedOnlineIVF`); not with
    ``quantize``. ``pq_m``: residual IVF-PQ with ``pq_m`` uint8 codes a
    row (requires ``ivf_nlist``, an immutable gallery); the best
    ``pq_rerank_factor * k_max`` ADC candidates are reranked exactly on
    rows kept in ``pq_rerank`` (``'float32'``, ``'bfloat16'``, or
    ``'none'``: the rows are dropped, values are ADC distances, and
    :meth:`save` refuses). ``pq_opq_iters``: learn an OPQ rotation.
    ``index_cache``: a directory that keeps the immutable IVF (and PQ)
    index as ``.npz`` (the JAX package's files); a cached index is taken
    only where it matches (metric, D, N, nlist, the shard layout), and a
    cached PQ only beside its cached IVF. ``startup_s`` holds the seconds
    of the IVF build (or load), the nprobe tuning and the PQ build (its
    assignment, training and encoding) or load.
    """

    def __init__(self, forward_fn: Callable[[torch.Tensor], torch.Tensor],
                 gallery_features, image_paths: Sequence[Path | str], *,
                 metric: str = "euclidean", image_size: int = 224,
                 resize_mode: str = "square", k_max: int = 10,
                 max_batch: int = 32, capacity: Optional[int] = None,
                 quantize: bool = False, rerank_factor: int = 4,
                 rerank_dtype: str = "float32",
                 query_forward_fn: Optional[Callable] = None,
                 device: str | torch.device | None = None, mesh=None,
                 ivf_nlist: Optional[int] = None, ivf_nprobe: int = 0,
                 pq_m: Optional[int] = None, pq_rerank: str = "bfloat16",
                 pq_rerank_factor: int = 64, pq_opq_iters: int = 0,
                 index_cache: Optional[Path | str] = None):
        self.device = resolve_device(device if mesh is None
                                     else mesh.devices[0])
        self.mesh = mesh
        n0 = int(gallery_features.shape[0])
        if n0 == 0 and capacity is None:
            raise ValueError("cannot serve an empty gallery "
                             "(pass capacity= to start an online index)")
        if len(image_paths) != n0:
            raise ValueError(f"{len(image_paths)} paths vs {n0} feature rows")
        self.image_paths = [str(p) for p in image_paths]
        self.metric = metric
        self.image_size = image_size
        self.resize_mode = resize_mode
        self.max_batch = max_batch
        self.buckets = _buckets(max_batch)
        self._forward = forward_fn
        self._query_forward = query_forward_fn or forward_fn
        self.per_modality_bn = query_forward_fn is not None
        self._lock = threading.Lock()  # guards gallery/mask/n_valid/paths

        feats = torch.as_tensor(gallery_features).to(self.device,
                                                     torch.float32)
        self.capacity = capacity
        if capacity is not None:
            if capacity < max(n0, 1):
                raise ValueError(f"capacity {capacity} < initial gallery {n0}")
            self.gallery = torch.zeros((capacity, feats.shape[1]),
                                       dtype=torch.float32, device=self.device)
            self.gallery[:n0] = feats
            self.k_max = min(k_max, capacity)
        else:
            self.gallery = feats.contiguous()
            self.k_max = min(k_max, n0)
        rows = int(self.gallery.shape[0])
        self._mask = torch.arange(rows, device=self.device) < n0
        self._devices = (self.device,) if mesh is None else mesh.devices
        self.n_shards = len(self._devices)
        if rows % self.n_shards:
            raise ValueError(
                f"gallery rows {rows} (pad with capacity=) must be divisible "
                f"by the mesh's first axis ({self.n_shards}) for "
                "row-sharded serving")
        self._n_local = rows // self.n_shards  # rows a shard
        if mesh is not None and self.k_max > self._n_local:
            raise ValueError(
                f"k_max={self.k_max} exceeds the per-shard gallery size "
                f"{self._n_local} for row-sharded serving")
        self.n_valid = n0
        self._next = n0  # next never-used slot
        self._free: List[int] = []  # tombstoned slots, reused by adds

        if index_cache is not None and (ivf_nlist is None
                                        or capacity is not None):
            raise ValueError("index_cache persists immutable IVF/IVF-PQ "
                             "indexes only (requires ivf_nlist, no "
                             "capacity= — online mutations would "
                             "invalidate the cache)")
        if ivf_nlist is not None and quantize:
            raise ValueError("ivf_nlist does not compose with quantize= — "
                             "pick one scan strategy")
        if ivf_nlist is not None and capacity is not None and n0 < 1:
            raise ValueError("online IVF needs a non-empty initial gallery "
                             "to cluster")
        if pq_m is not None:
            if ivf_nlist is None:
                raise ValueError("pq_m requires ivf_nlist= (IVF-PQ: the "
                                 "probe selects which codes to score)")
            if capacity is not None:
                raise ValueError("pq_m serves immutable indexes only "
                                 "(no capacity=/quantize=)")
            if pq_rerank not in ("none", "float32", "bfloat16"):
                raise ValueError(f"pq_rerank must be none|float32|bfloat16,"
                                 f" got {pq_rerank!r}")

        # the search route: 'K1', 'exact', 'K2', 'int8', 'ivf' or
        # 'ivf_pq'. K1 follows the JAX package's rule (see
        # retrieval/rank.py)
        self.route = ("K1" if (capacity is None and not quantize
                               and ivf_nlist is None
                               and metric in ("euclidean", "cosine")
                               and rows >= rank.FUSED_GALLERY_THRESHOLD
                               and self.k_max <= K_MAX) else "exact")
        # the K1 route's gallery norms: the gallery never changes
        self._gg = (gallery_norms(self.gallery, metric)
                    if self.route == "K1" else None)
        if mesh is not None and not quantize:
            if self.route == "K1":
                self.gallery, self._gg = shard_gallery(self.gallery, mesh,
                                                       self._gg, metric)
            else:
                self.gallery = shard_rows(self.gallery, mesh)
            self._mask = shard_rows(self._mask, mesh)

        self._qg = None
        if rerank_dtype != "float32" and not quantize:
            raise ValueError("rerank_dtype applies to quantize=True "
                             "engines only")
        if quantize:
            if capacity is not None:
                raise ValueError("quantize=True serves immutable indexes "
                                 "only (no capacity mode)")
            if rerank_dtype not in ("float32", "bfloat16"):
                raise ValueError(f"rerank_dtype must be float32|bfloat16, "
                                 f"got {rerank_dtype!r}")
            self._qg = quantize_gallery(self.gallery, metric)
            if rerank_dtype == "bfloat16":
                self.gallery = self.gallery.to(torch.bfloat16)
            self._rerank_factor = int(rerank_factor)
            # K2 wherever it runs, whatever the gallery's size: on an H100
            # its route beat the plain int8 scan's at every size measured
            # from 50,000 rows up, and trailed it by under 0.1 ms at 10,000
            # rows (PERF.md). Over a mesh each shard scans its own rows
            r = self._rerank_factor * self.k_max
            if mesh is not None:
                r = min(max(r, self.k_max), self._n_local)
            self.route = ("K2" if all(quant_fused.kernel_takes(
                d, r, int(self.gallery.shape[1])) for d in self._devices)
                else "int8")
            if mesh is not None:
                self._qg, self.gallery = shard_quant_gallery(
                    self._qg, self.gallery, mesh)
                self._mask = shard_rows(self._mask, mesh)

        self._ivf = None
        self._ivf_nprobe = int(ivf_nprobe)
        self._pq = None
        self.startup_s: Dict = {}
        if ivf_nlist is not None:
            self.route = "ivf"
            cached = self._build_ivf(int(ivf_nlist), n0, index_cache)
            if self._ivf_nprobe == 0:
                t0 = time.perf_counter()
                self._tune_nprobe(n0)
                self.startup_s["ivf_tune"] = time.perf_counter() - t0
            if pq_m is not None:
                self.route = "ivf_pq"
                self._build_pq(int(pq_m), n0, index_cache, cached,
                               int(pq_opq_iters))
                self._rerank_factor = int(pq_rerank_factor)
                if pq_rerank == "none":
                    self.gallery = None  # codes + table are the index
                elif pq_rerank == "bfloat16":
                    self.gallery = self._unshard([
                        g.to(torch.bfloat16)
                        for g in self._shards(self.gallery)])

    # ------------------------------------------------------------ indexes

    def _whole(self, x) -> torch.Tensor:
        """The gallery (or mask) in row order on ``self.device``."""
        if self.mesh is None:
            return x
        return torch.cat([p.to(self.device) for p in x])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _build_ivf(self, nlist: int, n0: int, index_cache) -> bool:
        """Build (or take from ``index_cache``) the IVF index; True where
        it came from the cache."""
        mesh, metric = self.mesh, self.metric
        n_clusters = nlist or None
        dim = int(self._shards(self.gallery)[0].shape[1])
        cache_dir = Path(index_cache) if index_cache else None
        if cache_dir is not None:
            cache_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        cached = False
        if mesh is not None and self.capacity is not None:
            self._ivf = ivf_ops.build_ivf_sharded_online(
                self.gallery, n0, self.n_shards, n_clusters, metric=metric,
                devices=mesh.devices)
        elif mesh is not None:
            f = cache_dir / "ivf_sharded.npz" if cache_dir else None
            if f is not None and f.exists():
                cand = ivf_ops.load_ivf_sharded(f, devices=self.device)
                if (cand.metric == metric
                        and int(cand.centroids[0].shape[1]) == dim
                        and cand.n_shards == self.n_shards
                        and cand.n_local == self._n_local
                        and int(cand.counts.sum()) == n0
                        and (nlist == 0 or cand.nlist == nlist)):
                    self._ivf = cand._replace(  # each shard on its device
                        centroids=ivf_ops._per_shard(cand.centroids, mesh),
                        row_ids=ivf_ops._per_shard(cand.row_ids, mesh))
                    cached = True
            if self._ivf is None:
                self._ivf = ivf_ops.build_ivf_sharded(
                    self.gallery, self.n_shards, n_clusters, metric=metric,
                    devices=mesh.devices)
                if f is not None:
                    ivf_ops.save_ivf_sharded(self._ivf, f)
        elif self.capacity is not None:
            self._ivf = ivf_ops.build_ivf_online(self.gallery, n0,
                                                 n_clusters, metric=metric)
        else:
            f = cache_dir / "ivf.npz" if cache_dir else None
            if f is not None and f.exists():
                cand = ivf_ops.load_ivf(f, device=self.device)
                if (cand.metric == metric
                        and int(cand.centroids.shape[1]) == dim
                        and int(cand.counts.sum()) == n0
                        and (nlist == 0 or cand.nlist == nlist)):
                    self._ivf, cached = cand, True
            if self._ivf is None:
                self._ivf = ivf_ops.build_ivf(self.gallery, n_clusters,
                                              metric=metric)
                if f is not None:
                    ivf_ops.save_ivf(self._ivf, f)
        self._sync()
        self.startup_s.update(ivf_build=time.perf_counter() - t0,
                              ivf_cached=cached)
        return cached

    def _tune_nprobe(self, n0: int) -> None:
        """The auto nprobe: :func:`~art_sbir_tpu_torch.ops.ivf.tune_nprobe`
        with margin 2 on a proxy of perturbed live rows, drawn with numpy's
        ``default_rng(0)`` as the JAX engine draws it (the same proxy for
        the same rows)."""
        idx, mesh = self._ivf, self.mesh
        if isinstance(idx, ivf_ops.OnlineIVF):
            idx = idx.as_index()
        elif isinstance(idx, ivf_ops.ShardedOnlineIVF):
            idx = idx.snapshot()[0]
        g_live = self._whole(self.gallery)[:n0]
        search_fn = None
        if mesh is not None:
            online = self.capacity is not None
            mask0 = self._mask if online else None
            spill0 = self._ivf.snapshot()[1] if online else None

            def search_fn(q, nprobe, k):
                return ivf_ops.ivf_search_sharded(
                    q, idx, self.gallery, mesh, nprobe=nprobe, k=k,
                    mask=mask0, spill=spill0)
        prng = np.random.default_rng(0)
        sel = prng.integers(0, n0, min(256, n0))
        rows = g_live[torch.as_tensor(sel, device=self.device)
                      ].cpu().numpy().astype(np.float32)
        proxy = rows + 0.05 * rows.std() * prng.standard_normal(
            rows.shape).astype(np.float32)
        self._ivf_nprobe = ivf_ops.tune_nprobe(
            idx, g_live, torch.from_numpy(proxy).to(self.device),
            k=self.k_max, search_fn=search_fn,
            margin=ivf_ops.SERVING_NPROBE_MARGIN)

    def _build_pq(self, m: int, n0: int, index_cache, ivf_cached: bool,
                  opq_iters: int) -> None:
        """Residual IVF-PQ codes (one shared codebook over a mesh), or
        the cached ones where they pair with the cached IVF."""
        sharded = self.mesh is not None
        pq_file = "pq_sharded.npz" if sharded else "pq.npz"
        f = Path(index_cache) / pq_file if index_cache else None
        t0 = time.perf_counter()
        k_codes = min(256, n0)
        if f is not None and ivf_cached and f.exists():
            # a rebuilt IVF has fresh centroids: only its own codes pair
            cb, codes = pq_ops.load_pq(f, device=self.device)
            if (cb.residual and cb.metric == self.metric and cb.m == m
                    and cb.k_codes == k_codes
                    and tuple(codes.shape) == (n0, m)
                    and (cb.rotation is not None) == bool(opq_iters)):
                self._pq = (cb, codes)
        cached = self._pq is not None
        if not cached:
            build = (pq_ops.build_ivf_pq_sharded if sharded
                     else pq_ops.build_ivf_pq)
            steps: Dict = {}
            self._pq = build(self.gallery, self._ivf, m, k_codes=k_codes,
                             opq_iters=opq_iters, timings=steps)
            self.startup_s.update({"pq_" + k: v for k, v in steps.items()})
            if f is not None:
                pq_ops.save_pq(*self._pq, f)
        if sharded:  # each shard's codes on its device
            self._pq = (self._pq[0], shard_rows(self._pq[1], self.mesh))
        self._sync()
        self.startup_s.update(pq_build=time.perf_counter() - t0,
                              pq_cached=cached)

    # ------------------------------------------------------------ queries

    def _embed(self, fwd: Callable, images_u8: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            emb = fwd(torch.from_numpy(images_u8).to(self.device))
        if isinstance(emb, (tuple, list)):  # classification models
            emb = emb[0]
        return emb.float()

    def embed_queries(self, images_u8: np.ndarray) -> torch.Tensor:
        """QUERY modality (sketches)."""
        return self._embed(self._query_forward, images_u8)

    def embed_gallery(self, images_u8: np.ndarray) -> torch.Tensor:
        """GALLERY modality (photos): ``/add`` rows match the resident
        gallery's embedding geometry."""
        return self._embed(self._forward, images_u8)

    def _pad(self, images_u8: np.ndarray) -> np.ndarray:
        b = images_u8.shape[0]
        bucket = next((x for x in self.buckets if x >= b), b)
        if bucket == b:
            return images_u8
        pad = np.zeros((bucket - b, *images_u8.shape[1:]), np.uint8)
        return np.concatenate([images_u8, pad])

    def decode(self, data: bytes) -> np.ndarray:
        """Image bytes (PNG/JPEG/...) -> uint8 (S, S, 3) query."""
        return decode_bytes(data, self.image_size, self.resize_mode)

    def search_arrays(self, images_u8: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 (B, S, S, 3) -> (top-k distances, top-k indices), padded
        to the enclosing bucket on the device, sliced back on the host."""
        b = images_u8.shape[0]
        with self._lock:  # a consistent (gallery, mask, index) state
            gallery, mask = self.gallery, self._mask
            ivf, spill = self._ivf, None
            if isinstance(ivf, ivf_ops.ShardedOnlineIVF):
                ivf, spill = ivf.snapshot()
            elif isinstance(ivf, ivf_ops.OnlineIVF):
                ivf, spill = ivf.as_index(), ivf.spill
        emb = self.embed_queries(self._pad(images_u8))
        if ivf is not None:
            vals, idx = self._search_ivf(emb, ivf, spill, gallery, mask)
            return vals[:b], idx[:b]
        if self.mesh is not None:
            vals, idx = self._search_sharded(emb, gallery, mask)
            return vals[:b], idx[:b]
        if self.route == "K2":  # results + certificate pulled together
            vals, idx = retrieve_quantized_fused(
                emb, self._qg, gallery, k=self.k_max,
                rerank_factor=self._rerank_factor, device_get=True)
        elif self.route == "int8":
            vals, idx = retrieve_quantized(
                emb, self._qg, gallery, k=self.k_max,
                rerank_factor=self._rerank_factor)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        elif self.route == "K1":
            pos = torch.zeros(emb.shape[0], dtype=torch.int32,
                              device=self.device)  # unused when serving
            _, vals, idx = retrieve_fused(emb, gallery, pos, k=self.k_max,
                                          metric=self.metric,
                                          with_ranks=False, device_get=True,
                                          gg=self._gg)
            if self.metric == "euclidean":  # K1 reports squared distances
                vals = np.sqrt(vals)
        else:
            with torch.no_grad():
                dist = pairwise_distance(emb, gallery, metric=self.metric)
                vals, idx = top_k(dist, self.k_max, valid=mask)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        return vals[:b], idx[:b]

    def _search_ivf(self, emb, ivf, spill, gallery, mask):
        """(top-k distances, indices) as numpy on the IVF or IVF-PQ route,
        pulled to the host in one copy."""
        mesh, k, nprobe = self.mesh, self.k_max, self._ivf_nprobe
        online = self.capacity is not None
        if self._pq is not None:
            cb, codes = self._pq
            if mesh is not None:
                vals, idx = pq_ops.ivf_pq_search_sharded(
                    emb, ivf, codes, cb, mesh, nprobe=nprobe, k=k,
                    rows=gallery, rerank_factor=self._rerank_factor)
            else:
                vals, idx = pq_ops.ivf_pq_search(
                    emb, ivf, codes, cb, nprobe=nprobe, k=k, rows=gallery,
                    rerank_factor=self._rerank_factor)
        elif mesh is not None:
            vals, idx = ivf_ops.ivf_search_sharded(
                emb, ivf, gallery, mesh, nprobe=nprobe, k=k,
                mask=mask if online else None, spill=spill)
        else:  # the live mask gates tombstones and unpublished adds
            vals, idx = ivf_ops.ivf_search(
                emb, ivf, gallery, nprobe=nprobe, k=k,
                mask=mask if online else None, spill=spill)
        # one copy: the float32 values' bits beside the int32 indices
        both = torch.stack([vals.contiguous().view(torch.int32),
                            idx.to(torch.int32)]).cpu().numpy()
        return both[0].view(np.float32), both[1]

    def _search_sharded(self, emb, gallery, mask):
        """(top-k distances, indices) as numpy over the row-sharded
        gallery: each shard on its own device, merged on the first."""
        mesh, k = self.mesh, self.k_max
        if self.route in ("K2", "int8"):
            vals, idx = retrieve_quantized_sharded(
                emb, self._qg, gallery, mesh, k=k,
                rerank_factor=self._rerank_factor,
                use_kernel=self.route == "K2")
        elif self.route == "K1":
            pos = torch.zeros(emb.shape[0], dtype=torch.int32,
                              device=self.device)  # unused when serving
            _, vals, idx = retrieve_fused_sharded(
                emb, gallery, pos, mesh, k=k, metric=self.metric,
                with_ranks=False, device_get=True, gg=self._gg)
            return (np.sqrt(vals) if self.metric == "euclidean" else vals,
                    idx)
        else:  # exact: each shard's masked top-k, global indices, merged
            part_v, part_i = [], []
            # the queries reach every card before any shard's work is
            # queued (a copy runs behind the source card's queued work)
            embs = [emb.to(g.device) for g in gallery]
            with torch.no_grad():
                for i, (g, m, e) in enumerate(zip(gallery, mask, embs)):
                    dist = pairwise_distance(e, g, metric=self.metric)
                    v, il = top_k(dist, k, valid=m)
                    part_v.append(v)
                    part_i.append(il + i * self._n_local)
                vals, idx = lexsort_topk_merge(gather_to(part_v, self.device),
                                               gather_to(part_i, self.device),
                                               k)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def _shards(self, x) -> list:
        """The per-device pieces of the gallery or the mask (one piece
        without a mesh)."""
        return list(x) if self.mesh is not None else [x]

    def _unshard(self, xs: list):
        return xs if self.mesh is not None else xs[0]

    def embed_items(self, items: Sequence[Tuple[bytes, str]]
                    ) -> torch.Tensor:
        """The ``/add`` path's decode + gallery embedding, (b, D)."""
        imgs = np.stack([self.decode(data) for data, _ in items])
        return self.embed_gallery(self._pad(imgs))[:len(items)]

    def add_images(self, items: Sequence[Tuple[bytes, str]]) -> List[int]:
        """Online index update: decode + embed each (image_bytes, path)
        and write it into a free slot, tombstoned slots first. Requires
        ``capacity`` mode. Returns the assigned slots."""
        if self.capacity is None:
            raise ValueError("immutable index: construct with capacity= "
                             "to enable add_images")
        if not items:
            return []
        emb = self.embed_items(items)
        b = len(items)
        with self._lock:
            if self.n_valid + b > self.capacity:
                raise ValueError(
                    f"index full: {self.n_valid}+{b} > {self.capacity}")
            slots = []
            for _ in range(b):
                slot = self._free.pop() if self._free else self._next
                if slot == self._next:
                    self._next += 1
                slots.append(slot)
            # copy and write each piece that takes a slot (slot s is row
            # s % n_local of piece s // n_local)
            gallery = self._shards(self.gallery)
            mask = self._shards(self._mask)
            for sh in sorted({s // self._n_local for s in slots}):
                mine = [i for i, s in enumerate(slots)
                        if s // self._n_local == sh]
                dev = gallery[sh].device
                at = torch.tensor([slots[i] % self._n_local for i in mine],
                                  device=dev)
                gallery[sh] = gallery[sh].clone()
                gallery[sh][at] = emb[torch.tensor(mine, device=emb.device)
                                      ].to(dev)
                mask[sh] = mask[sh].clone()
                mask[sh][at] = True
            for i, slot in enumerate(slots):
                if slot < len(self.image_paths):
                    self.image_paths[slot] = items[i][1]
                else:
                    self.image_paths.append(items[i][1])
            if self._ivf is not None:  # cluster routing of the new rows
                self._ivf.add(slots, emb)
            self.gallery = self._unshard(gallery)
            self._mask = self._unshard(mask)
            self.n_valid += b
        return slots

    def remove(self, paths: Sequence[str]) -> List[int]:
        """Tombstone the slots serving these paths (first match each);
        their rows leave results at once and later adds reuse the slots.
        Returns the freed slots."""
        if self.capacity is None:
            raise ValueError("immutable index: construct with capacity= "
                             "to enable remove")
        with self._lock:
            mask, copied = self._shards(self._mask), set()
            freed: List[int] = []
            try:
                for p in paths:
                    try:
                        slot = self.image_paths.index(p)
                    except ValueError:
                        raise KeyError(f"path not in index: {p}") from None
                    self.image_paths[slot] = None  # tombstone
                    sh, row = divmod(slot, self._n_local)
                    if sh not in copied:
                        mask[sh] = mask[sh].clone()
                        copied.add(sh)
                    mask[sh][row] = False
                    if self._ivf is not None:
                        self._ivf.remove(slot)  # recycle the cluster slot
                    self._free.append(slot)
                    freed.append(slot)
            finally:  # paths freed before a missing one stay freed
                self._mask = self._unshard(mask)
                self.n_valid -= len(freed)
        return freed

    def save(self, model_name: str = "ServedIndex",
             dataset_name: str = "online",
             root: Path | str = Path("data/image_features")) -> str:
        """Persist the live rows as a standard gallery feature cache.
        Returns the cache folder name."""
        if self.gallery is None:
            raise ValueError("pq_rerank='none' dropped the exact rows; "
                             "there is nothing full-precision to save")
        with self._lock:
            gallery, mask = self.gallery, self._mask
            paths = list(self.image_paths)
        if self.mesh is not None:  # the pieces, in row order
            gallery = torch.cat([g.to(self.device) for g in gallery])
            mask = torch.cat([m.to(self.device) for m in mask])
        live = torch.nonzero(mask).flatten()
        feats = gallery[live].float().cpu().numpy()  # numpy has no bf16
        return save_image_features(
            model_name, dataset_name, [paths[i] for i in live.tolist()],
            feats, root=root)

    def search(self, image_bytes: bytes, k: Optional[int] = None) -> Dict:
        """Single query -> {paths, distances}. Synchronous; for the
        coalescing path use :class:`MicroBatcher`."""
        vals, idx = self.search_arrays(self.decode(image_bytes)[None])
        return self._result(vals[0], idx[0], k)

    def health_stats(self) -> Dict:
        """A consistent snapshot for ``/healthz``, taken under the engine
        lock (a sharded online index's stats build its cached snapshot,
        which a racing add would otherwise leave stale)."""
        with self._lock:
            out: Dict = {
                "status": "ok",
                "gallery_size": int(self.n_valid),
                "capacity": self.capacity,
                "metric": self.metric,
                "image_size": self.image_size,
                "k_max": self.k_max,
                "per_modality_bn": self.per_modality_bn,
                "shards": self.n_shards,
            }
            if self._ivf is not None:
                out["ivf"] = {**self._ivf.stats(),
                              "nprobe": self._ivf_nprobe}
            if self._pq is not None:
                rows = self._shards(self.gallery)[0] if (
                    self.gallery is not None) else None
                out["pq"] = {
                    "m": self._pq[0].m,
                    "k_codes": self._pq[0].k_codes,
                    "bytes_per_row": self._pq[0].m,
                    "rows_resident": (str(rows.dtype).replace("torch.", "")
                                      if rows is not None else "dropped"),
                    "rerank_factor": self._rerank_factor,
                }
            return out

    def _result(self, vals: np.ndarray, idx: np.ndarray,
                k: Optional[int]) -> Dict:
        # int() validates a request-supplied k here, in the caller's
        # request, not inside a shared batch
        k = self.k_max if k is None else min(int(k), self.k_max)
        vals, idx = vals[:k], idx[:k]
        live = np.isfinite(vals)  # masked (empty) slots rank at +inf
        return {
            "paths": [self.image_paths[int(i)] for i in idx[live]],
            "distances": [float(v) for v in vals[live]],
        }


class MicroBatcher:
    """Coalesces concurrent single queries into one device dispatch.

    The first request in an empty queue opens a ``window_ms`` window;
    every request arriving inside it (up to ``engine.max_batch``) rides
    one :meth:`RetrievalEngine.search_arrays` call. Each caller blocks
    only on its own result.
    """

    def __init__(self, engine: RetrievalEngine, window_ms: float = 2.0):
        self.engine = engine
        self.window_s = window_ms / 1e3
        self.stats = ServerStats()
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="retrieval-microbatch")
        self._thread.start()

    def search(self, image_bytes: bytes, k: Optional[int] = None,
               timeout: Optional[float] = 600.0) -> Dict:
        """Thread-safe; blocks until this query's results are ready."""
        img = self.engine.decode(image_bytes)  # decode on the caller thread
        return self._wait(self._submit(img, k), timeout)

    def call(self, fn: Callable[[], object],
             timeout: Optional[float] = 600.0):
        """Run ``fn()`` on the dispatch thread, between batches, and return
        its result (or raise its exception). See the module docstring."""
        return self._wait(self._submit(fn, None), timeout)

    def _submit(self, payload, k) -> tuple:
        item = (payload, k, threading.Event(), [None])
        self._q.put(item)
        return item

    @staticmethod
    def _wait(item: tuple, timeout: Optional[float]):
        _, _, ev, slot = item
        if not ev.wait(timeout):
            raise TimeoutError("retrieval dispatch timed out")
        if isinstance(slot[0], BaseException):
            raise slot[0]
        return slot[0]

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=10)

    def _collect(self) -> Optional[List[tuple]]:
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        waited = False
        # drain what is queued; on first emptiness wait out the window
        # once, drain again, then dispatch
        while len(batch) < self.engine.max_batch:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                if waited:
                    break
                waited = True
                if self.window_s > 0:
                    time.sleep(self.window_s)
                continue
            if nxt is None:
                self._q.put(None)  # re-post the shutdown sentinel
                break
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            queries = []
            for item in batch:
                if not callable(item[0]):
                    queries.append(item)
                    continue
                fn, _, ev, slot = item
                try:
                    slot[0] = fn()
                except Exception as e:  # raised again in the caller
                    slot[0] = e
                ev.set()
            if not queries:
                continue
            batch = queries
            imgs = np.stack([b[0] for b in batch])
            try:
                vals, idx = self.engine.search_arrays(imgs)
            except Exception as e:  # the whole dispatch failed
                for _, _, ev, slot in batch:
                    slot[0] = e
                    ev.set()
                continue
            self.stats.record(len(batch))
            # one request's bad parameters (a non-int k) fail only that
            # request; a slot is never touched after its event is set
            for i, (_, k, ev, slot) in enumerate(batch):
                try:
                    slot[0] = self.engine._result(vals[i], idx[i], k)
                except Exception as e:
                    slot[0] = e
                ev.set()


def engine_from_feature_cache(forward_fn: Callable, folder_name: str,
                              root: Path | str = Path("data/image_features"),
                              **kw) -> RetrievalEngine:
    """An engine over a saved gallery cache (``.npy`` or reference CSV)."""
    paths, feats = load_image_features(folder_name, root)
    return RetrievalEngine(forward_fn, feats.astype(np.float32), paths, **kw)
