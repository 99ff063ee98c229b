"""IVF (inverted-file) clustered index: a sublinear candidate scan.

Counterpart of ``art_sbir_tpu/ops/ivf.py``, with its contract: a full scan
reads the whole ``N x D`` gallery a dispatch, a probe gathers ``B * nprobe
* Cpad`` rows whatever N is, so the probe wins where serving lives (small
B, large N).

* **Build**: Lloyd's k-means over row chunks (assignment the
  ``precision='default'`` ``pairwise_sq_l2`` argmin, the centroid update a
  weighted one-hot matmul in float32), on a seeded row sample, k-means++
  seeded; cosine clusters L2-normalized rows with spherical k-means.
* **Layout**: a ``(C, Cpad)`` int32 table of gallery row ids per cluster,
  ``Cpad`` the largest cluster rounded up to 8, pad slots ``N``.
* **Search**: the centroid probe (the ``nprobe`` smallest of a tiny
  (Q, C) distance matrix), candidate ids sorted ascending, one gather of
  the candidate rows (cast to float32 after the gather), exact row-wise
  distances (``ops/distance.py``), a stable sort. Candidates sorted by
  index before a stable sort on distance break exact ties by gallery
  index, so ``nprobe == nlist`` equals
  :func:`art_sbir_tpu_torch.ops.distance.retrieve`, duplicates included.

Decisions of the port:

* **Random streams.** JAX's ``jax.random`` streams cannot be reproduced in
  torch. The fit sample is ``torch.randperm`` on a CPU ``torch.Generator``
  seeded ``seed + 1`` (the same rows on every device); k-means++ draws
  with ``torch.multinomial`` on the squared distances from a generator on
  the rows' device seeded ``seed`` (deterministic on one device, not
  across devices). What carries across packages is the index file
  (``ivf.npz``, ``ivf_sharded.npz``: the same keys, dtypes and metric
  string), so a search over a shared index is held exact, and a build by
  its steps and its quality.
* **Precision.** ``precision='default'`` sites stay ``'default'``: the
  port rounds both operands of the cross term to bf16 as the TPU does
  (the JAX package computes in float32 on the CPU). The products JAX
  writes without a precision (the cosine probe, the one-hot centroid
  sums) run in IEEE float32, as JAX runs them on the CPU.
* **Tie order.** Every top-k is a stable sort (``torch.topk`` leaves the
  order among ties unspecified).
* **Updates.** :class:`OnlineIVF` never writes into a tensor it has
  published: an add or a removal clones the table (or the spill buffer),
  writes the new slots, and publishes the new tensor, so a search holding
  the old ``row_ids``/``spill`` keeps them whole, as JAX's functional
  ``.at[].set`` does. The host bookkeeping is numpy and Python, line for
  line JAX's.
* **Memory.** Queries are chunked so the gathered (Qc, nprobe * Cpad, D)
  float32 block stays under ``row_budget_bytes`` (JAX's formula).
* **Sharding.** A :class:`ShardedIVF` holds one local index per shard of
  a :class:`~art_sbir_tpu_torch.parallel.mesh.Mesh`; its ``centroids`` and
  ``row_ids`` are stacked (S, ...) tensors or sequences of S per-shard
  tensors (shard ``s`` on ``mesh.devices[s]``). Each shard probes, gathers
  and scores on its own device, every shard's inputs sent before any
  shard's work is queued, and the (Q, k) partials merge by (value, global
  index) on ``mesh.devices[0]``.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from art_sbir_tpu_torch.core.device import ieee_f32, resolve_device
from art_sbir_tpu_torch.ops.distance import (cosine_distance,
                                             euclidean_distance,
                                             pairwise_sq_l2)
from art_sbir_tpu_torch.ops.sharded import gather_to, lexsort_topk_merge

_METRICS = ("euclidean", "cosine")


class IVFIndex(NamedTuple):
    """Clustered index over a gallery (which stays owned by the caller).

    ``row_ids`` slot value ``N`` (one past the gallery's rows) marks
    padding; ``centroids`` and ``row_ids`` lie on the index's device."""

    centroids: torch.Tensor  # (C, D) float32; L2-normalized for cosine
    row_ids: torch.Tensor    # (C, Cpad) int32, pad slots = N
    counts: np.ndarray       # (C,) int64 host copy
    metric: str

    @property
    def nlist(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def pad_width(self) -> int:
        return int(self.row_ids.shape[1])

    def stats(self) -> dict:
        """Cluster-balance diagnostics (``pad_overhead``: Cpad over the
        mean count, the padding paid a probe)."""
        return _balance(self.counts, self.nlist, self.pad_width)


def _balance(c: np.ndarray, nlist: int, pad_width: int) -> dict:
    mean = float(c.mean()) if c.size else 0.0
    return {
        "nlist": nlist,
        "pad_width": pad_width,
        "min_count": int(c.min()) if c.size else 0,
        "max_count": int(c.max()) if c.size else 0,
        "mean_count": mean,
        "empty_clusters": int((c == 0).sum()),
        "pad_overhead": (pad_width / mean) if mean else 0.0,
    }


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` in IEEE float32."""
    ieee_f32()
    return a @ b.T


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def _sample_rows(n: int, sample: int, seed: int, device) -> torch.Tensor:
    """``sample`` distinct row ids of ``n``, drawn on the CPU (the same rows
    on every device)."""
    sel = torch.randperm(n, generator=_generator(seed, "cpu"))[:sample]
    return sel.to(device)


def _smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Column ids of each row's ``k`` smallest values, ascending, ties by
    column (JAX's ``lax.top_k`` of ``-x``)."""
    return torch.sort(x, dim=1, stable=True).indices[:, :k]


def _kmeans_step(x: torch.Tensor, w: torch.Tensor, cent: torch.Tensor, *,
                 chunk: int, spherical: bool) -> torch.Tensor:
    """One Lloyd's iteration over (padded) rows ``x`` with row weights
    ``w`` (0 for pad rows). Empty clusters keep their centroid."""
    c, d = cent.shape
    sums = torch.zeros((c, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros(c, dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], chunk):
        xc, wc = x[i:i + chunk], w[i:i + chunk]
        d2 = pairwise_sq_l2(xc, cent, precision="default")
        assign = torch.argmin(d2, dim=1)
        onehot = torch.zeros((xc.shape[0], c), dtype=torch.float32,
                             device=x.device)
        onehot.scatter_(1, assign[:, None], wc[:, None])
        ieee_f32()
        sums = sums + onehot.T @ xc
        counts = counts + torch.sum(onehot, dim=0)
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts, min=1.0)[:, None], cent)
    return _l2n(new) if spherical else new


def _assign(x: torch.Tensor, cent: torch.Tensor, *, chunk: int
            ) -> torch.Tensor:
    """Nearest-centroid label per row, int32, ``chunk`` rows at a time
    (a last partial chunk is padded, so every product has one shape)."""
    labels = []
    for i in range(0, x.shape[0], chunk):
        xc = x[i:i + chunk].float()
        rows = xc.shape[0]
        if rows < chunk:
            xc = torch.cat([xc, xc.new_zeros((chunk - rows, xc.shape[1]))])
        d2 = pairwise_sq_l2(xc, cent, precision="default")
        labels.append(torch.argmin(d2, dim=1)[:rows].to(torch.int32))
    if not labels:
        return torch.zeros(0, dtype=torch.int32, device=x.device)
    return torch.cat(labels)


def _pad_rows(x: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    n = x.shape[0]
    rem = (-n) % chunk
    w = torch.cat([torch.ones(n, dtype=torch.float32, device=x.device),
                   torch.zeros(rem, dtype=torch.float32, device=x.device)])
    if rem:
        x = torch.cat([x, x.new_zeros((rem, x.shape[1]))])
    return x, w, n


def _kmeanspp_init(x: torch.Tensor, gen: torch.Generator, *, c: int
                   ) -> torch.Tensor:
    """k-means++ seeding (Arthur & Vassilvitskii 2007): each next center is
    drawn with probability proportional to the squared distance to the
    nearest chosen one. ``x`` is (N, D), or (M, N, D) for M independent
    seedings at once (the PQ subspaces). Where every row duplicates a
    chosen center the draw is uniform."""
    batched = x.dim() == 3
    xs = x if batched else x[None]
    m, n, d = xs.shape
    rows = torch.arange(m, device=x.device)
    first = torch.randint(0, n, (m,), generator=gen, device=x.device)
    cent = torch.zeros((m, c, d), dtype=torch.float32, device=x.device)
    newc = xs[rows, first]  # (M, D)
    cent[:, 0] = newc
    d2min = torch.sum(torch.square(xs - newc[:, None]), dim=2)
    for i in range(1, c):
        weights = torch.where((d2min > 0).any(dim=1, keepdim=True), d2min,
                              torch.ones_like(d2min))
        idx = torch.multinomial(weights, 1, generator=gen)[:, 0]
        newc = xs[rows, idx]
        cent[:, i] = newc
        d2min = torch.minimum(d2min,
                              torch.sum(torch.square(xs - newc[:, None]),
                                        dim=2))
    return cent if batched else cent[0]


def kmeans(x: torch.Tensor, n_clusters: int, *, iters: int = 10,
           seed: int = 0, chunk: int = 16384, spherical: bool = False
           ) -> torch.Tensor:
    """Lloyd's k-means on ``x``'s device -> (C, D) float32 centroids,
    k-means++ seeded. ``spherical=True`` re-normalizes the centroids each
    iteration (expects normalized ``x``). Deterministic for a given
    (seed, shapes, device)."""
    x = x.float()
    n = x.shape[0]
    if not 1 <= n_clusters <= n:
        raise ValueError(f"n_clusters must be in [1, {n}], got {n_clusters}")
    cent = _kmeanspp_init(x, _generator(seed, x.device), c=n_clusters)
    if spherical:
        cent = _l2n(cent)
    chunk = min(chunk, max(n, 1))
    xp, w, _ = _pad_rows(x, chunk)
    for _ in range(iters):
        cent = _kmeans_step(xp, w, cent, chunk=chunk, spherical=spherical)
    return cent


def build_ivf(gallery: torch.Tensor, n_clusters: Optional[int] = None, *,
              metric: str = "euclidean", iters: int = 10, seed: int = 0,
              sample: int = 131072, chunk: int = 16384) -> IVFIndex:
    """Cluster a gallery into an :class:`IVFIndex` on the gallery's device.

    ``n_clusters`` defaults to ``~2*sqrt(N)``. k-means fits on a seeded
    ``sample`` of rows, then every row is assigned. Cosine clusters
    L2-normalized rows with spherical k-means."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}; one of {_METRICS}")
    n = int(gallery.shape[0])
    if n == 0:
        raise ValueError("cannot build an IVF index over an empty gallery")
    if n_clusters is None:
        n_clusters = max(1, min(n, int(2 * np.sqrt(n))))
    with torch.no_grad():
        g = gallery.float()
        gx = _l2n(g) if metric == "cosine" else g
        fit = gx
        sample = max(sample, n_clusters)  # the fit set must cover the init
        if n > sample:
            fit = gx[_sample_rows(n, sample, seed + 1, gx.device)]
        cent = kmeans(fit, n_clusters, iters=iters, seed=seed,
                      chunk=min(chunk, int(fit.shape[0])),
                      spherical=(metric == "cosine"))
        labels = _assign(gx, cent, chunk=min(chunk, n)).cpu().numpy()
    table, counts = pack_table(labels, n_clusters, n)
    return IVFIndex(cent, torch.as_tensor(table, device=cent.device), counts,
                    metric)


# The serving engine's auto-tune margin and the JAX package's golden
# regeneration probe agree on this factor: the perturbed-row proxy measured
# one power of two optimistic against real cross-modal queries (the JAX
# package's goldens/ann_learned_tpu.json).
SERVING_NPROBE_MARGIN = 2


def apply_nprobe_margin(nprobe: int, nlist: int,
                        margin: int = SERVING_NPROBE_MARGIN) -> int:
    """The one place the safety margin is applied to a tuned nprobe."""
    if margin < 1:
        raise ValueError(f"margin must be >= 1, got {margin}")
    return min(int(nprobe) * margin, int(nlist))


def tune_nprobe(index, gallery: torch.Tensor, queries: torch.Tensor, *,
                k: int = 10, target_recall: float = 0.95, search_fn=None,
                margin: int = 1) -> int:
    """Smallest power-of-two ``nprobe`` whose recall@k on ``queries``
    against the exact route over the same gallery meets
    ``target_recall``, times ``margin`` (capped at ``nlist``); ``nlist``
    where none does. ``index`` is anything with ``.nlist`` and
    ``.metric``; ``search_fn(q, nprobe, k) -> (vals, ids)`` replaces the
    single-device :func:`ivf_search` over ``index`` (the sharded engine
    passes :func:`ivf_search_sharded`)."""
    from art_sbir_tpu_torch.ops.distance import retrieve_chunked
    from art_sbir_tpu_torch.ops.quant import topk_overlap

    if not 0.0 < target_recall <= 1.0:
        raise ValueError(f"target_recall must be in (0, 1], got "
                         f"{target_recall}")
    apply_nprobe_margin(1, 1, margin)  # validates margin up front
    if search_fn is None:
        def search_fn(q, nprobe, k):
            return ivf_search(q, index, gallery, nprobe=nprobe, k=k)
    q = queries.to(gallery.device).float()
    k = min(k, int(gallery.shape[0]))
    with torch.no_grad():
        _, _, exact = retrieve_chunked(
            q, gallery.float(), torch.zeros(q.shape[0], dtype=torch.int32,
                                            device=q.device),
            k=k, metric=index.metric, chunk=max(int(q.shape[0]), 1))
    exact = exact.cpu().numpy()
    nprobe = 1
    while nprobe < index.nlist:
        _, ids = search_fn(q, nprobe, k)
        if topk_overlap(ids, exact) >= target_recall:
            return apply_nprobe_margin(nprobe, index.nlist, margin)
        nprobe *= 2
    return index.nlist


def save_ivf(index: IVFIndex, path) -> None:
    """One ``.npz`` (centroids, table, counts, metric), the JAX package's
    keys and dtypes: each package loads the other's."""
    np.savez_compressed(
        path, centroids=index.centroids.cpu().numpy(),
        row_ids=index.row_ids.cpu().numpy(), counts=index.counts,
        metric=np.asarray(index.metric))


def load_ivf(path, device=None) -> IVFIndex:
    """An index saved by either package, on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        return IVFIndex(torch.as_tensor(z["centroids"], device=dev),
                        torch.as_tensor(z["row_ids"], device=dev),
                        z["counts"].astype(np.int64), str(z["metric"]))


def pack_table(labels: np.ndarray, n_clusters: int,
               n_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row labels -> ((C, Cpad) int32 table with pad slots
    ``n_rows``, (C,) int64 counts). Row ids ascend within each cluster
    (the tie-order contract)."""
    counts = np.bincount(labels, minlength=n_clusters).astype(np.int64)
    pad = int(counts.max()) if n_clusters else 1
    pad = max(8, -(-pad // 8) * 8)  # a multiple of 8, at least 8
    table = np.full((n_clusters, pad), n_rows, dtype=np.int32)
    order = np.argsort(labels, kind="stable")  # ids ascend within a cluster
    offsets = np.zeros(n_clusters, np.int64)
    offsets[1:] = np.cumsum(counts)[:-1]
    for c in range(n_clusters):
        rows = order[offsets[c]: offsets[c] + counts[c]]
        table[c, : len(rows)] = rows
    return table, counts


def _probe(qp: torch.Tensor, centroids: torch.Tensor, metric: str,
           nprobe: int) -> torch.Tensor:
    """The ``nprobe`` nearest clusters of each (normalized for cosine)
    query, nearest first: the probe only selects clusters, so the
    euclidean distances take ``precision='default'``."""
    cdist = (pairwise_sq_l2(qp, centroids, precision="default")
             if metric == "euclidean" else -_dot(qp, centroids))
    return _smallest(cdist, nprobe)


def _ivf_core(queries: torch.Tensor, centroids: torch.Tensor,
              row_ids: torch.Tensor, gallery: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              spill: Optional[torch.Tensor] = None, *, metric: str, k: int,
              nprobe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    n = gallery.shape[0]
    qf = queries.float()
    qp = _l2n(qf) if metric == "cosine" else qf
    probe = _probe(qp, centroids, metric, nprobe)  # (Q, P)
    ids = row_ids[probe].reshape(qf.shape[0], -1)
    if spill is not None and spill.shape[0]:
        # overflow rows (their cluster was full) are always scanned
        ids = torch.cat([ids, spill[None].expand(qf.shape[0], -1)], dim=1)
    if mask is not None:
        # tombstoned rows rank as padding: the live mask is the source of
        # truth, the cluster table only routes
        live = mask[torch.clamp(ids, max=n - 1).long()]
        ids = torch.where(live, ids, n)
    ids = torch.sort(ids, dim=1).values  # pads (= n) last; ties by index
    rows = gallery[torch.clamp(ids, max=n - 1).long()].float()  # (Q, R, D)
    qx = qf[:, None, :]
    exact = (euclidean_distance(qx, rows) if metric == "euclidean"
             else cosine_distance(qx, rows))
    exact = torch.where(ids >= n, torch.inf, exact)
    order = torch.sort(exact, dim=1, stable=True).indices[:, :k]
    return (torch.gather(exact, 1, order),
            torch.gather(ids, 1, order).to(torch.int32))


def _empty(k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros((0, k), dtype=torch.float32, device=device),
            torch.zeros((0, k), dtype=torch.int32, device=device))


def ivf_search(queries: torch.Tensor, index: IVFIndex,
               gallery: torch.Tensor, *, nprobe: int = 8, k: int = 10,
               row_budget_bytes: int = 1 << 30,
               mask: Optional[torch.Tensor] = None,
               spill: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k over the probed clusters -> (values, int32
    indices) on the gallery's device.

    Scored distances are exact (``gallery`` may be bf16-resident: rows
    are cast after the gather). Queries are chunked so the gathered
    (Qc, nprobe*Cpad, D) float32 block stays under ``row_budget_bytes``.
    Slots past the valid candidates rank at ``+inf`` with index ``N``.
    ``mask``: optional (N,) bool of live rows. ``spill``: optional (S,)
    int32 row ids scanned unconditionally (pad = N)."""
    if nprobe < 1:
        raise ValueError(f"nprobe must be >= 1, got {nprobe}")
    nprobe = min(nprobe, index.nlist)
    n = int(gallery.shape[0])
    r = nprobe * index.pad_width + (
        int(spill.shape[0]) if spill is not None else 0)
    k = min(k, r, n)
    d = int(gallery.shape[1])
    qc = max(1, int(row_budget_bytes // max(r * d * 4, 1)))
    nq = queries.shape[0]
    if nq == 0:
        return _empty(k, gallery.device)
    queries = queries.to(gallery.device)
    with torch.no_grad():
        outs = [_ivf_core(queries[i: i + qc], index.centroids, index.row_ids,
                          gallery, mask, spill, metric=index.metric, k=k,
                          nprobe=nprobe)
                for i in range(0, nq, qc)]
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def _assign_online(rows: torch.Tensor, centroids: torch.Tensor, *,
                   metric: str) -> torch.Tensor:
    """Nearest shared centroid per row (spherical for cosine)."""
    rf = rows.to(centroids.device).float()
    rx = _l2n(rf) if metric == "cosine" else rf
    d2 = pairwise_sq_l2(rx, centroids, precision="default")
    return torch.argmin(d2, dim=1).to(torch.int32)


class OnlineIVF:
    """Mutable IVF over a fixed-capacity gallery buffer (the serving
    engine's ``capacity=`` mode).

    The (C, Cpad) table and the (S,) spill buffer keep their shapes (pad
    sentinel: the buffer's capacity); slot bookkeeping lives on the host.

    * **add**: a row goes to its nearest centroid, into a free slot of that
      cluster (freed slots first); a full cluster overflows into the spill
      buffer, which every search scans, so overflow costs bandwidth, never
      recall.
    * **remove**: the slot is reset to the pad sentinel and recycled. The
      engine's live mask stays the source of truth.
    * **repack**: when the spill buffer fills, the table is rebuilt from
      the bookkeeping with a wider ``Cpad`` (``slack`` headroom). Centroids
      are never retrained online (``stats()['repacks']`` is the signal to
      rebuild offline).

    Every mutation publishes new ``row_ids``/``spill`` tensors (see the
    module note) and never writes into a published one.
    """

    def __init__(self, index: IVFIndex, built_over: int, capacity: int, *,
                 spill_capacity: int = 256, slack: float = 1.25):
        if built_over > capacity:
            raise ValueError(f"built_over {built_over} > capacity "
                             f"{capacity}")
        self.metric = index.metric
        self.centroids = index.centroids
        self._device = index.row_ids.device
        self.capacity = int(capacity)  # pad sentinel for every device id
        self.slack = float(slack)
        c, p = index.row_ids.shape
        table = index.row_ids.cpu().numpy().copy()
        table[table == built_over] = self.capacity  # remap build-time pads
        self.repacks = 0
        # host bookkeeping: row -> slot, per-cluster free slots, fill
        self._loc: dict = {}
        self._free_t: list = [[] for _ in range(c)]
        self._fill = np.zeros(c, np.int64)
        for ci in range(c):
            for ji in range(p):
                rid = int(table[ci, ji])
                if rid == self.capacity:
                    self._free_t[ci].append(ji)
                else:
                    self._loc[rid] = ("t", ci, ji)
                    self._fill[ci] += 1
        self._free_t = [list(reversed(f)) for f in self._free_t]  # low first
        spill_capacity = max(8, int(spill_capacity))
        self._free_s = list(range(spill_capacity))[::-1]
        self._spill_np = np.full(spill_capacity, self.capacity, np.int32)
        # torch.tensor copies: a CPU tensor must not share the bookkeeping
        self.row_ids = torch.tensor(table, device=self._device)
        self.spill = torch.tensor(self._spill_np, device=self._device)

    def _assign_rows(self, rows: torch.Tensor) -> torch.Tensor:
        return _assign_online(rows, self.centroids, metric=self.metric)

    @property
    def nlist(self) -> int:
        return int(self.centroids.shape[0])

    # ------------------------------------------------------------- index ops

    def add(self, row_ids: Sequence[int], rows: torch.Tensor,
            labels: Optional[Sequence[int]] = None) -> None:
        """Insert buffer rows ``row_ids`` with embeddings ``rows`` (B, D);
        trailing rows past ``len(row_ids)`` are ignored. ``labels``
        (aligned with ``row_ids``) skips the assignment where the caller
        has assigned the batch (:class:`ShardedOnlineIVF`)."""
        if len(row_ids) > int(rows.shape[0]):
            raise ValueError(f"{len(row_ids)} ids vs {rows.shape[0]} rows")
        if not len(row_ids):
            return
        if labels is None:
            labels = self._assign_rows(rows).cpu().numpy()[: len(row_ids)]
        else:
            if len(labels) < len(row_ids):
                raise ValueError(f"{len(labels)} labels vs "
                                 f"{len(row_ids)} ids")
            labels = np.asarray(labels, np.int32)[: len(row_ids)]
        # validate the whole batch (range, duplicates) before touching any
        # state, so a bad id cannot leave a half-inserted batch behind
        batch_seen: set = set()
        for rid in row_ids:
            rid = int(rid)
            if rid in self._loc or rid in batch_seen:
                raise ValueError(f"row {rid} already indexed")
            if not 0 <= rid < self.capacity:
                raise ValueError(f"row id {rid} outside [0, {self.capacity})")
            batch_seen.add(rid)
        table_w, spill_w = [], []  # (cluster, slot, row), (slot, row)
        for rid, ci in zip(row_ids, labels):
            rid, ci = int(rid), int(ci)
            if self._free_t[ci]:
                j = self._free_t[ci].pop()
                table_w.append((ci, j, rid))
                self._loc[rid] = ("t", ci, j)
                self._fill[ci] += 1
            else:
                if not self._free_s:
                    # the repacked table holds every row added so far
                    self._repack()
                    table_w.clear()
                    spill_w.clear()
                    j = self._free_t[ci].pop()
                    table_w.append((ci, j, rid))
                    self._loc[rid] = ("t", ci, j)
                    self._fill[ci] += 1
                    continue
                j = self._free_s.pop()
                spill_w.append((j, rid))
                self._spill_np[j] = rid
                self._loc[rid] = ("s", j, ci)
                self._fill[ci] += 1
        self._publish(table_w, spill_w)

    def _publish(self, table_w: list, spill_w: list) -> None:
        """Copy the table (or spill buffer), write the slots, publish."""
        if table_w:
            ci, j, v = (torch.as_tensor(col, device=self._device)
                        for col in zip(*table_w))
            tab = self.row_ids.clone()
            tab[ci, j] = v.to(torch.int32)
            self.row_ids = tab
        if spill_w:
            j, v = (torch.as_tensor(col, device=self._device)
                    for col in zip(*spill_w))
            sp = self.spill.clone()
            sp[j] = v.to(torch.int32)
            self.spill = sp

    def remove(self, row_id: int) -> None:
        """Free the slot serving buffer row ``row_id``."""
        where = self._loc.pop(int(row_id), None)
        if where is None:
            raise KeyError(f"row {row_id} not in the IVF index")
        if where[0] == "t":
            _, ci, j = where
            self._publish([(ci, j, self.capacity)], [])
            self._free_t[ci].append(j)
        else:
            _, j, ci = where
            self._publish([], [(j, self.capacity)])
            self._spill_np[j] = self.capacity
            self._free_s.append(j)
        self._fill[ci] -= 1

    def _repack(self) -> None:
        """Rebuild the table with ``slack`` headroom; drain the spill."""
        c = int(self.centroids.shape[0])
        max_fill = int(self._fill.max()) if c else 0
        pad = max(max_fill + 8, int(self.slack * max_fill))
        pad = max(8, -(-pad // 8) * 8)
        table = np.full((c, pad), self.capacity, np.int32)
        nxt = np.zeros(c, np.int64)
        loc = {}
        for rid, where in sorted(self._loc.items()):  # ids ascend per row
            ci = where[1] if where[0] == "t" else where[2]
            j = int(nxt[ci])
            table[ci, j] = rid
            loc[rid] = ("t", ci, j)
            nxt[ci] += 1
        self._loc = loc
        self._free_t = [list(range(int(nxt[ci]), pad))[::-1]
                        for ci in range(c)]
        self._spill_np[:] = self.capacity
        self._free_s = list(range(len(self._spill_np)))[::-1]
        self.row_ids = torch.tensor(table, device=self._device)
        self.spill = torch.tensor(self._spill_np, device=self._device)
        self.repacks += 1

    # ------------------------------------------------------------- queries

    def search(self, queries: torch.Tensor, gallery: torch.Tensor, *,
               nprobe: int = 8, k: int = 10,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return ivf_search(queries, self.as_index(), gallery, nprobe=nprobe,
                          k=k, mask=mask, spill=self.spill)

    def as_index(self) -> IVFIndex:
        return IVFIndex(self.centroids, self.row_ids, self._fill.copy(),
                        self.metric)

    def stats(self) -> dict:
        out = self.as_index().stats()
        out.update(spill_used=int((self._spill_np != self.capacity).sum()),
                   spill_capacity=len(self._spill_np),
                   repacks=self.repacks, live_rows=len(self._loc))
        return out


def build_ivf_online(gallery_buffer: torch.Tensor, n_valid: int,
                     n_clusters: Optional[int] = None, *,
                     metric: str = "euclidean", spill_capacity: int = 256,
                     slack: float = 1.25, **kw) -> OnlineIVF:
    """Cluster the first ``n_valid`` live rows of a fixed-capacity buffer
    (slots ``0..n_valid-1``, the engine's layout) and wrap the result for
    online mutation."""
    if n_valid < 1:
        raise ValueError("online IVF needs >= 1 initial live row to "
                         "cluster (capacity-only cold starts should "
                         "add rows first, then build)")
    capacity = int(gallery_buffer.shape[0])
    idx = build_ivf(gallery_buffer[:n_valid], n_clusters, metric=metric,
                    **kw)
    return OnlineIVF(idx, n_valid, capacity, spill_capacity=spill_capacity,
                     slack=slack)


# --------------------------------------------------------------- sharded IVF

def _devices(devices, n: int, default) -> List[torch.device]:
    """``n`` devices: a sequence as given, one device (or ``None``: the
    ``default``) repeated."""
    if devices is None:
        devices = default
    if isinstance(devices, (str, torch.device)):
        return [torch.device(devices)] * n
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"want {n} devices, got {len(devices)}")
    return devices


def _row_shards(x, mesh) -> List[torch.Tensor]:
    """Shard ``i`` of an (N, ...) tensor's rows, or of a sequence of S row
    shards, on ``mesh.devices[i]``."""
    if isinstance(x, torch.Tensor):
        from art_sbir_tpu_torch.parallel.mesh import shard_rows

        return shard_rows(x, mesh)
    return [p.to(d) for p, d in zip(x, mesh.devices)]


def _per_shard(x, mesh) -> List[torch.Tensor]:
    """Item ``i`` of a stacked (S, ...) tensor or of S tensors, on
    ``mesh.devices[i]``."""
    return [x[i].to(d) for i, d in enumerate(mesh.devices)]


class ShardedIVF(NamedTuple):
    """Row-sharded IVF: one independent local index per gallery shard.

    Shard ``s`` owns the contiguous rows ``[s*n_local, (s+1)*n_local)``
    and clusters them with local row ids (pad sentinel ``n_local``), so a
    probe's gathers stay on the shard's device; ``nprobe`` clusters are
    probed on every shard. ``centroids`` / ``row_ids``: stacked (S, C, D)
    / (S, C, Cpad) tensors or sequences of S per-shard tensors (see the
    module note); ``counts`` is an (S, C) host copy."""

    centroids: Any
    row_ids: Any
    counts: np.ndarray
    metric: str
    n_local: int

    @property
    def n_shards(self) -> int:
        return len(self.centroids)

    @property
    def nlist(self) -> int:
        """Clusters a shard (the nprobe upper bound)."""
        return int(self.centroids[0].shape[0])

    @property
    def pad_width(self) -> int:
        return int(self.row_ids[0].shape[1])

    def stats(self) -> dict:
        """:meth:`IVFIndex.stats` over every shard-local cluster, plus the
        sharding layout."""
        return {"n_shards": self.n_shards, "rows_per_shard": self.n_local,
                **_balance(self.counts, self.nlist, self.pad_width)}


def build_ivf_sharded(gallery, n_shards: int,
                      n_clusters: Optional[int] = None, *,
                      metric: str = "euclidean", iters: int = 10,
                      seed: int = 0, sample: int = 131072,
                      chunk: int = 16384, devices=None) -> ShardedIVF:
    """Cluster each contiguous N/n_shards row block into its own local IVF
    (:func:`build_ivf` a block, seed offset by shard) and pad the tables
    to one common width. ``gallery``: an (N, D) tensor or a sequence of
    ``n_shards`` row shards. Shard ``s``'s index lies on ``devices[s]``
    (default: its rows' device)."""
    if isinstance(gallery, torch.Tensor):
        n = int(gallery.shape[0])
        if n_shards < 1 or n % n_shards:
            raise ValueError(f"gallery rows ({n}) must be divisible by "
                             f"n_shards ({n_shards}); pad the gallery")
        n_local = n // n_shards
        parts = [gallery[s * n_local:(s + 1) * n_local]
                 for s in range(n_shards)]
    else:
        parts = list(gallery)
        n_local = int(parts[0].shape[0])
        if len(parts) != n_shards or any(int(p.shape[0]) != n_local
                                         for p in parts):
            raise ValueError(f"want {n_shards} row shards of one size")
    devs = _devices(devices, n_shards, [p.device for p in parts])
    locals_ = [build_ivf(p.to(d), n_clusters, metric=metric, iters=iters,
                         seed=seed + s, sample=sample, chunk=chunk)
               for s, (p, d) in enumerate(zip(parts, devs))]
    pad = max(ix.pad_width for ix in locals_)
    tables = []
    for ix in locals_:
        t = torch.full((ix.nlist, pad), n_local, dtype=torch.int32,
                       device=ix.row_ids.device)
        t[:, :ix.pad_width] = ix.row_ids
        tables.append(t)
    return ShardedIVF([ix.centroids for ix in locals_], tables,
                      np.stack([ix.counts for ix in locals_]), metric,
                      n_local)


def save_ivf_sharded(index: ShardedIVF, path) -> None:
    """The sharded analog of :func:`save_ivf` (``n_local`` pins the shard
    layout); the JAX package's keys and dtypes."""
    np.savez_compressed(
        path, centroids=np.stack([c.cpu().numpy() for c in index.centroids]),
        row_ids=np.stack([t.cpu().numpy() for t in index.row_ids]),
        counts=index.counts, metric=np.asarray(index.metric),
        n_local=np.asarray(index.n_local))


def load_ivf_sharded(path, devices=None) -> ShardedIVF:
    """A sharded index saved by either package; shard ``s`` on
    ``devices[s]`` (one device, or default the card, for every shard)."""
    with np.load(path) as z:
        cent, tab = z["centroids"], z["row_ids"]
        devs = _devices(devices, cent.shape[0],
                        resolve_device(None) if devices is None else devices)
        return ShardedIVF(
            [torch.as_tensor(c, device=d) for c, d in zip(cent, devs)],
            [torch.as_tensor(t, device=d) for t, d in zip(tab, devs)],
            z["counts"].astype(np.int64), str(z["metric"]),
            int(z["n_local"]))


def _n_rows(x) -> int:
    return (int(x.shape[0]) if isinstance(x, torch.Tensor)
            else sum(int(p.shape[0]) for p in x))


def _sharded_core(queries, mesh, n_local: int, k: int, core):
    """Run ``core(s, q_s)`` -> (vals, local ids) on each shard, queries
    sent to every shard before any shard's work is queued; merge the
    (Q, k) partials by (value, global index) on ``mesh.devices[0]``."""
    n = mesh.size * n_local
    dev0 = mesh.devices[0]
    sent = [queries.to(d) for d in mesh.devices]
    part_v, part_i = [], []
    for s, q in enumerate(sent):
        vals, ids = core(s, q)
        part_v.append(vals)
        part_i.append(torch.where(ids >= n_local, n,
                                  ids + s * n_local).to(torch.int32))
    return lexsort_topk_merge(gather_to(part_v, dev0),
                              gather_to(part_i, dev0), k)


def ivf_search_sharded(queries: torch.Tensor, index: ShardedIVF, gallery,
                       mesh, *, axis_name: Optional[str] = None,
                       nprobe: int = 8, k: int = 10,
                       row_budget_bytes: int = 1 << 30, mask=None,
                       spill=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k over a row-sharded gallery -> (values, GLOBAL
    int32 indices) on ``mesh.devices[0]``.

    Every shard probes its ``nprobe`` nearest local clusters and scores
    its candidates exactly; the merge orders by (value, global index), so
    ``nprobe == index.nlist`` equals the exact route (values, indices,
    tie order). ``gallery``: (N, D) or S row shards. ``row_budget_bytes``
    bounds each shard's gathered block. ``mask``: optional (N,) bool of
    live GLOBAL rows (or S shards of it). ``spill``: optional (S, Sp)
    int32 per-shard overflow rows with LOCAL ids (pad ``n_local``), or S
    of them: :class:`ShardedOnlineIVF` state."""
    if nprobe < 1:
        raise ValueError(f"nprobe must be >= 1, got {nprobe}")
    ax = axis_name or mesh.axis_name
    n_dev = mesh.size
    if n_dev != index.n_shards:
        raise ValueError(f"index built for {index.n_shards} shards, mesh "
                         f"'{ax}' axis has {n_dev}")
    n = _n_rows(gallery)
    if n != n_dev * index.n_local:
        raise ValueError(f"gallery rows ({n}) != n_shards*n_local "
                         f"({n_dev}*{index.n_local})")
    if k > index.n_local:
        raise ValueError(f"k={k} exceeds the per-shard gallery size "
                         f"{index.n_local}; shrink the mesh axis or pad "
                         "the gallery")
    nprobe = min(nprobe, index.nlist)
    r = nprobe * index.pad_width + (
        int(spill[0].shape[0]) if spill is not None else 0)
    k = min(k, r, n)
    d = int(gallery[0].shape[-1])
    qc = max(1, int(row_budget_bytes // max(r * d * 4, 1)))
    nq = queries.shape[0]
    if nq == 0:
        return _empty(k, mesh.devices[0])
    cents = _per_shard(index.centroids, mesh)
    tabs = _per_shard(index.row_ids, mesh)
    gals = _row_shards(gallery, mesh)
    masks = _row_shards(mask, mesh) if mask is not None else None
    spills = _per_shard(spill, mesh) if spill is not None else None

    def core(s, q):
        return _ivf_core(q, cents[s], tabs[s], gals[s],
                         masks[s] if masks is not None else None,
                         spills[s] if spills is not None else None,
                         metric=index.metric, k=k, nprobe=nprobe)

    with torch.no_grad():
        outs = [_sharded_core(queries[i: i + qc].float(), mesh,
                              index.n_local, k, core)
                for i in range(0, nq, qc)]
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


# ------------------------------------------------------- sharded online IVF

class ShardedOnlineIVF:
    """Mutable sharded IVF over a row-sharded fixed-capacity buffer (the
    serving engine's ``capacity= + mesh=`` mode).

    One centroid set, trained on the initial live rows, is shared by every
    shard (shards whose slot range starts empty have nothing to fit); each
    shard keeps its own :class:`OnlineIVF` table and spill over its slot
    range ``[s*cap_local, (s+1)*cap_local)`` with local ids, on its own
    device. Shared centroids mean the global candidate set at an nprobe
    equals the single-device :class:`OnlineIVF`'s (spill aside)."""

    def __init__(self, centroids: torch.Tensor, shards: Sequence[OnlineIVF],
                 cap_local: int, metric: str):
        self.centroids = centroids  # (C, D) shared, never retrained
        self.shards = list(shards)
        self.cap_local = int(cap_local)
        self.metric = metric
        self._snap = None  # invalidated by every mutation

    @property
    def nlist(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def capacity(self) -> int:
        return self.n_shards * self.cap_local

    # ------------------------------------------------------------- index ops

    def add(self, row_ids: Sequence[int], rows: torch.Tensor) -> None:
        """Insert buffer rows ``row_ids`` (GLOBAL slot ids) with embeddings
        ``rows`` (B, D), each routed to the shard owning its slot and
        assigned to its nearest shared centroid (one assignment for the
        whole batch)."""
        if len(row_ids) > int(rows.shape[0]):
            raise ValueError(f"{len(row_ids)} ids vs {rows.shape[0]} rows")
        if not len(row_ids):
            return
        # validate the whole batch before committing any shard
        batch_seen: set = set()
        for rid in row_ids:
            rid = int(rid)
            if not 0 <= rid < self.capacity:
                raise ValueError(
                    f"row id {rid} outside [0, {self.capacity})")
            s, local = divmod(rid, self.cap_local)
            if local in self.shards[s]._loc or rid in batch_seen:
                raise ValueError(f"row {rid} already indexed")
            batch_seen.add(rid)
        groups: dict = {}
        for pos, rid in enumerate(row_ids):
            groups.setdefault(int(rid) // self.cap_local, []).append(pos)
        labels = self.shards[0]._assign_rows(rows).cpu().numpy()[
            : len(row_ids)]
        for s in sorted(groups):
            poss = groups[s]
            self.shards[s].add(
                [int(row_ids[p]) % self.cap_local for p in poss],
                rows, labels=[int(labels[p]) for p in poss])
        self._snap = None

    def remove(self, row_id: int) -> None:
        rid = int(row_id)
        s, local = divmod(rid, self.cap_local)
        if not 0 <= s < self.n_shards:
            raise KeyError(f"row {rid} not in the IVF index")
        try:
            self.shards[s].remove(local)
        except KeyError:
            raise KeyError(f"row {rid} not in the IVF index") from None
        self._snap = None

    # ------------------------------------------------------------- queries

    def snapshot(self) -> Tuple[ShardedIVF, List[torch.Tensor]]:
        """(immutable :class:`ShardedIVF` view, S spill buffers) for
        :func:`ivf_search_sharded`, cached until the next mutation. Shard
        tables repack independently, so their widths are padded to one
        common ``Cpad`` here (pad sentinel ``cap_local``)."""
        if self._snap is None:
            pad = max(int(s.row_ids.shape[1]) for s in self.shards)
            tabs = [torch.nn.functional.pad(
                        s.row_ids, (0, pad - int(s.row_ids.shape[1])),
                        value=self.cap_local)
                    if int(s.row_ids.shape[1]) != pad else s.row_ids
                    for s in self.shards]
            index = ShardedIVF(
                [s.centroids for s in self.shards], tabs,
                np.stack([s._fill.copy() for s in self.shards]),
                self.metric, self.cap_local)
            self._snap = (index, [s.spill for s in self.shards])
        return self._snap

    def search(self, queries: torch.Tensor, gallery, mesh, *,
               nprobe: int = 8, k: int = 10, mask=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        index, spill = self.snapshot()
        return ivf_search_sharded(queries, index, gallery, mesh,
                                  nprobe=nprobe, k=k, mask=mask, spill=spill)

    def stats(self) -> dict:
        index, _ = self.snapshot()
        out = index.stats()
        out.update(
            spill_used=sum(int((s._spill_np != s.capacity).sum())
                           for s in self.shards),
            spill_capacity=sum(len(s._spill_np) for s in self.shards),
            repacks=sum(s.repacks for s in self.shards),
            live_rows=sum(len(s._loc) for s in self.shards))
        return out


def build_ivf_sharded_online(gallery_buffer, n_valid: int, n_shards: int,
                             n_clusters: Optional[int] = None, *,
                             metric: str = "euclidean",
                             spill_capacity: int = 256, slack: float = 1.25,
                             devices=None, **kw) -> ShardedOnlineIVF:
    """Cluster the first ``n_valid`` live rows of a row-sharded
    fixed-capacity buffer (one shared k-means, see
    :class:`ShardedOnlineIVF`), then split the cluster table by owning
    shard into per-shard :class:`OnlineIVF` state with local slot ids.
    ``gallery_buffer``: a (capacity, D) tensor or ``n_shards`` row shards;
    shard ``s``'s state lies on ``devices[s]`` (default: its rows'
    device)."""
    parts = (None if isinstance(gallery_buffer, torch.Tensor)
             else list(gallery_buffer))
    capacity = _n_rows(gallery_buffer)
    if n_shards < 1 or capacity % n_shards:
        raise ValueError(f"buffer capacity ({capacity}) must be divisible "
                         f"by n_shards ({n_shards}); pad the buffer")
    if n_valid < 1:
        raise ValueError("online IVF needs >= 1 initial live row to "
                         "cluster (capacity-only cold starts should "
                         "add rows first, then build)")
    cap_local = capacity // n_shards
    if parts is None:
        live = gallery_buffer[:n_valid]
        default = [gallery_buffer.device] * n_shards
    else:
        dev0 = parts[0].device
        live = torch.cat([p.to(dev0) for p in parts])[:n_valid]
        default = [p.device for p in parts]
    devs = _devices(devices, n_shards, default)
    idx = build_ivf(live.to(devs[0]), n_clusters, metric=metric, **kw)
    c = idx.nlist
    # invert the table -> per-row labels (the initial rows are the
    # contiguous prefix, so a shard's local ids are slot - s*cap_local)
    table = idx.row_ids.cpu().numpy()
    labels = np.empty(n_valid, np.int32)
    for ci in range(c):
        rows = table[ci][table[ci] < n_valid]
        labels[rows] = ci
    shards = []
    for s in range(n_shards):
        lo = min(s * cap_local, n_valid)
        hi = min(lo + cap_local, n_valid)
        tab_s, counts_s = pack_table(labels[lo:hi], c, cap_local)
        shards.append(OnlineIVF(
            IVFIndex(idx.centroids.to(devs[s]),
                     torch.as_tensor(tab_s, device=devs[s]), counts_s,
                     metric),
            cap_local, cap_local, spill_capacity=spill_capacity,
            slack=slack))
    return ShardedOnlineIVF(idx.centroids, shards, cap_local, metric)
