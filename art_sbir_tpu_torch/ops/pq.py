"""Product quantization (IVF-PQ): approximate serving at extreme capacity.

Counterpart of ``art_sbir_tpu/ops/pq.py``. Each D-dim row is split into
``M`` subspaces and stored as one uint8 code a subspace, ``M`` bytes a
row; IVF only misses candidates, PQ also scores them approximately
(distance to the reconstruction), and an optional exact rerank over the
best ``rerank_factor * k`` ADC candidates repairs the ordering where the
rows stay resident.

* **Train** (:func:`train_pq`): per-subspace k-means, every subspace at
  once (batched k-means++ seeding, batched Lloyd's on a row sample); OPQ
  (``opq_iters``) alternates codebook fits with the orthogonal Procrustes
  solve (SVD of the (D, D) cross-covariance on the host).
* **Encode** (:func:`encode_pq`): the nearest centroid a subspace,
  ``chunk`` rows at a time -> (N, M) uint8.
* **Residual build** (:func:`build_ivf_pq`): codes quantize ``x - c(x)``
  against each row's IVF centroid (FAISS ``by_residual``).
* **Search** (:func:`ivf_pq_search`): the IVF probe, the candidate codes
  gathered, ADC scores from a per-query (M, 256) table, a stable top-k,
  optionally reranked exactly on gathered rows.

Decisions of the port (the IVF ones are in :mod:`art_sbir_tpu_torch.ops.
ivf`'s note and hold here: random streams, ``precision='default'`` at the
same sites, float32 where JAX writes no precision, stable sorts):

* **The ADC score.** JAX sums one-hot(code) x LUT matmuls in a 64-step
  scan because gathers lost on the TPU; the one-hot product is exactly
  ``LUT[m, code_m]``. The port takes one gather of the (Q, M, K) table at
  the codes and sums the M terms in subspace order, as the scan adds them,
  so the sum equals JAX's wherever the table does. It never builds the
  (Q, R, K) one-hot.
* **Memory.** Queries are chunked by JAX's per-query formula (candidate
  codes, a (R, K) scan step, the tables) under ``row_budget_bytes``.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from art_sbir_tpu_torch.core.device import ieee_f32, resolve_device
from art_sbir_tpu_torch.ops.distance import (cosine_distance,
                                             euclidean_distance)
from art_sbir_tpu_torch.ops.ivf import (IVFIndex, ShardedIVF, _assign,
                                        _dot, _empty, _generator,
                                        _kmeanspp_init, _l2n, _n_rows,
                                        _per_shard, _probe, _row_shards,
                                        _sample_rows, _sharded_core)

_METRICS = ("euclidean", "cosine")


class PQCodebook(NamedTuple):
    """Per-subspace centroids. For cosine the codebook is trained on (and
    codes encode) L2-normalized rows and the ADC table scores dot
    products. ``residual``: the codebook quantizes IVF residuals
    ``x - c(x)``. ``rotation``: an optional (D, D) orthogonal matrix (OPQ)
    applied before the subspace split; distances and dots are unchanged
    by it."""

    centroids: torch.Tensor  # (M, K, ds) float32
    metric: str
    residual: bool = False
    rotation: Optional[torch.Tensor] = None  # (D, D) orthogonal

    @property
    def m(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def k_codes(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def ds(self) -> int:
        return int(self.centroids.shape[2])

    @property
    def dim(self) -> int:
        return self.m * self.ds


def _split(rows: torch.Tensor, m: int) -> torch.Tensor:
    """(N, D) -> (M, N, ds)."""
    n, d = rows.shape
    return rows.reshape(n, m, d // m).permute(1, 0, 2)


def _batched_sq_l2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(M, N, ds) x (M, K, ds) -> (M, N, K) squared L2 a subspace, the op
    order of ``ops/distance.py::pairwise_sq_l2`` at ``precision='default'``
    (cross-term operands rounded to bf16, float32 sums)."""
    x = x.float()
    c = c.float()
    xx = torch.sum(x * x, dim=-1, keepdim=True)  # (M, N, 1)
    cc = torch.sum(c * c, dim=-1)[:, None, :]  # (M, 1, K)
    cross = torch.bmm(x.to(torch.bfloat16).float(),
                      c.to(torch.bfloat16).float().transpose(1, 2))
    return torch.clamp(xx + cc - 2.0 * cross, min=0.0)


def _train_pq_core(xs: torch.Tensor, gen: torch.Generator, *, k: int,
                   iters: int, chunk: int = 16384) -> torch.Tensor:
    """Every subspace's k-means at once: xs (M, Nf, ds) -> (M, k, ds).
    Lloyd's sums are weighted one-hot products in float32, ``chunk`` rows
    at a time."""
    m, nf, ds = xs.shape
    cent = _kmeanspp_init(xs, gen, c=k)
    for _ in range(iters):
        sums = torch.zeros((m, k, ds), dtype=torch.float32, device=xs.device)
        counts = torch.zeros((m, k), dtype=torch.float32, device=xs.device)
        for i in range(0, nf, chunk):
            xc = xs[:, i:i + chunk]
            assign = torch.argmin(_batched_sq_l2(xc, cent), dim=2)  # (M, n)
            onehot = torch.zeros((m, xc.shape[1], k), dtype=torch.float32,
                                 device=xs.device)
            onehot.scatter_(2, assign[..., None], 1.0)
            ieee_f32()
            sums = sums + torch.bmm(onehot.transpose(1, 2), xc)
            counts = counts + torch.sum(onehot, dim=1)
        cent = torch.where(counts[..., None] > 0,
                           sums / torch.clamp(counts, min=1.0)[..., None],
                           cent)
    return cent


def train_pq(rows: torch.Tensor, m: int = 64, *, k_codes: int = 256,
             metric: str = "euclidean", iters: int = 10, seed: int = 0,
             sample: int = 65536, opq_iters: int = 0) -> PQCodebook:
    """Fit per-subspace codebooks on a seeded row sample (on the rows'
    device). ``opq_iters > 0`` also learns the OPQ rotation by
    alternating codebook refits with ``R = U V^T`` of ``X^T X_recon``."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}; one of {_METRICS}")
    x = rows.float()
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by m={m}")
    if not 1 <= k_codes <= 256:
        raise ValueError(f"k_codes must be in [1, 256] (uint8 codes), "
                         f"got {k_codes}")
    if n < k_codes:
        raise ValueError(f"need >= k_codes={k_codes} rows to train, got {n}")
    with torch.no_grad():
        if metric == "cosine":
            x = _l2n(x)
        if n > sample:
            x = x[_sample_rows(n, sample, seed + 1, x.device)]

        def fit(xr):
            return _train_pq_core(_split(xr, m), _generator(seed, x.device),
                                  k=k_codes, iters=iters)

        if not opq_iters:
            return PQCodebook(fit(x), metric)
        ieee_f32()
        rot = torch.eye(d, dtype=torch.float32, device=x.device)
        for _ in range(opq_iters):
            xr = x @ rot
            cent = fit(xr)
            codes = _encode_core(xr, cent, chunk=min(16384, int(x.shape[0])))
            recon = pq_decode(codes, PQCodebook(cent, "euclidean"))
            # orthogonal Procrustes: argmin_R ||x R - recon||_F, R = U V^T
            u, _, vt = np.linalg.svd((x.T @ recon).cpu().numpy(),
                                     full_matrices=False)
            rot = torch.as_tensor(u @ vt, dtype=torch.float32,
                                  device=x.device)
        return PQCodebook(fit(x @ rot), metric, False, rot)


def _encode_core(rows: torch.Tensor, cent: torch.Tensor, *,
                 chunk: int) -> torch.Tensor:
    """Rows -> (N, M) uint8, ``chunk`` rows at a time (a last partial
    chunk is padded, so every product has one shape)."""
    m = cent.shape[0]
    out = []
    for i in range(0, rows.shape[0], chunk):
        xc = rows[i:i + chunk].float()
        n = xc.shape[0]
        if n < chunk:
            xc = torch.cat([xc, xc.new_zeros((chunk - n, xc.shape[1]))])
        d2 = _batched_sq_l2(_split(xc, m), cent)  # (M, chunk, K)
        out.append(torch.argmin(d2, dim=2).T[:n].to(torch.uint8))
    if not out:
        return torch.zeros((0, m), dtype=torch.uint8, device=rows.device)
    return torch.cat(out)


def encode_pq(rows: torch.Tensor, cb: PQCodebook, *,
              chunk: int = 16384) -> torch.Tensor:
    """Rows -> (N, M) uint8 codes (L2-normalized first for a non-residual
    cosine codebook)."""
    x = rows.float()
    n, d = x.shape
    if d != cb.dim:
        raise ValueError(f"rows dim {d} != codebook dim {cb.dim}")
    with torch.no_grad():
        if cb.metric == "cosine" and not cb.residual:
            # residual codebooks quantize IVF residuals as given (the
            # caller normalized before subtracting)
            x = _l2n(x)
        if cb.rotation is not None:
            ieee_f32()
            x = x @ cb.rotation  # OPQ: codes live in the rotated space
        return _encode_core(x, cb.centroids, chunk=min(chunk, max(n, 1)))


def _lap(timings: Optional[dict], key: str, t0: float, device) -> float:
    """With ``timings``, record the seconds since ``t0`` under ``key``
    (the device's queued work finished first); the time now."""
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
    return time.perf_counter()


def build_ivf_pq(gallery: torch.Tensor, index: IVFIndex, m: int = 64, *,
                 k_codes: int = 256, iters: int = 10, seed: int = 0,
                 sample: int = 65536, chunk: int = 16384,
                 opq_iters: int = 0, timings: Optional[dict] = None
                 ) -> Tuple[PQCodebook, torch.Tensor]:
    """Residual IVF-PQ over an existing IVF index -> (codebook, (N, M)
    uint8 codes). Rows are assigned to their clusters, the codebooks are
    trained on a seeded sample of the residuals ``x - c(x)`` (plain L2
    for both metrics; cosine residuals live among normalized rows), and
    the residuals are encoded ``chunk`` rows at a time (the whole residual
    matrix never exists). ``timings`` (a dict) receives the seconds of
    the three steps: ``assign_s``, ``train_s``, ``encode_s``."""
    with torch.no_grad():
        t = time.perf_counter()
        g = gallery.float()
        n, d = g.shape
        if index.metric == "cosine":
            g = _l2n(g)
        ck = min(chunk, max(n, 1))
        labels = _assign(g, index.centroids, chunk=ck).long()
        t = _lap(timings, "assign_s", t, g.device)
        if n > sample:
            sel = _sample_rows(n, sample, seed + 1, g.device)
            res_s = g[sel] - index.centroids[labels[sel]]
        else:
            res_s = g - index.centroids[labels]
        base = train_pq(res_s, m, k_codes=k_codes, metric="euclidean",
                        iters=iters, seed=seed, sample=sample,
                        opq_iters=opq_iters)
        cb = PQCodebook(base.centroids, index.metric, True, base.rotation)
        t = _lap(timings, "train_s", t, g.device)
        codes = torch.cat([
            encode_pq(g[i:i + ck] - index.centroids[labels[i:i + ck]], cb,
                      chunk=ck)
            for i in range(0, n, ck)])
        _lap(timings, "encode_s", t, g.device)
    return cb, codes


def build_ivf_pq_sharded(gallery, index: ShardedIVF, m: int = 64, *,
                         k_codes: int = 256, iters: int = 10, seed: int = 0,
                         sample: int = 65536, chunk: int = 16384,
                         opq_iters: int = 0, timings: Optional[dict] = None
                         ) -> Tuple[PQCodebook, torch.Tensor]:
    """Residual IVF-PQ over a :class:`~art_sbir_tpu_torch.ops.ivf.
    ShardedIVF` -> (one shared codebook, (N, M) uint8 codes in global row
    order). Each row's residual is against its centroid in its own
    shard's index; the codebook is trained once on a residual sample
    pooled from every shard (``sample // S`` rows each), so ADC values
    compare across shards. ``gallery``: (N, D) or S row shards. The
    codebook and codes lie on shard 0's index device. ``timings`` as in
    :func:`build_ivf_pq`."""
    if not isinstance(index, ShardedIVF):
        raise ValueError("build_ivf_pq_sharded needs a ShardedIVF "
                         "(use build_ivf_pq for single-device indexes)")
    s_count, n_local = index.n_shards, index.n_local
    n = _n_rows(gallery)
    if n != s_count * n_local:
        raise ValueError(f"gallery rows ({n}) != n_shards*n_local "
                         f"({s_count}*{n_local})")
    with torch.no_grad():
        t = time.perf_counter()
        cents = [index.centroids[s] for s in range(s_count)]
        if isinstance(gallery, torch.Tensor):
            parts = [gallery[s * n_local:(s + 1) * n_local]
                     for s in range(s_count)]
        else:
            parts = list(gallery)
        parts = [p.to(c.device).float() for p, c in zip(parts, cents)]
        if index.metric == "cosine":
            parts = [_l2n(p) for p in parts]
        ck = min(chunk, max(n_local, 1))
        labels = [_assign(p, c, chunk=ck).long()
                  for p, c in zip(parts, cents)]
        dev0 = cents[0].device
        t = _lap(timings, "assign_s", t, dev0)
        # a pooled sample, proportional per shard, gathered directly (the
        # shard's whole residual matrix never exists)
        per = max(1, min(sample // s_count, n_local))
        pooled = []
        for s in range(s_count):
            sel = _sample_rows(n_local, per, seed + 1 + s, parts[s].device)
            pooled.append((parts[s][sel] - cents[s][labels[s][sel]]).to(dev0))
        base = train_pq(torch.cat(pooled), m, k_codes=k_codes,
                        metric="euclidean", iters=iters, seed=seed,
                        sample=sample, opq_iters=opq_iters)
        cb = PQCodebook(base.centroids, index.metric, True, base.rotation)
        t = _lap(timings, "train_s", t, dev0)
        codes = []
        for s in range(s_count):
            cb_s = _codebook_on(cb, parts[s].device)
            for lo in range(0, n_local, ck):
                res = parts[s][lo:lo + ck] - cents[s][labels[s][lo:lo + ck]]
                codes.append(encode_pq(res, cb_s, chunk=ck).to(dev0))
        codes = torch.cat(codes)
        _lap(timings, "encode_s", t, dev0)
    return cb, codes


def _codebook_on(cb: PQCodebook, device) -> PQCodebook:
    return PQCodebook(cb.centroids.to(device), cb.metric, cb.residual,
                      None if cb.rotation is None
                      else cb.rotation.to(device))


def save_pq(cb: PQCodebook, codes: torch.Tensor, path) -> None:
    """A codebook and its codes as one ``.npz`` (pairs with
    :func:`~art_sbir_tpu_torch.ops.ivf.save_ivf`); the JAX package's keys
    and dtypes."""
    extra = ({"rotation": cb.rotation.cpu().numpy()}
             if cb.rotation is not None else {})
    np.savez_compressed(
        path, centroids=cb.centroids.cpu().numpy(),
        metric=np.asarray(cb.metric), residual=np.asarray(cb.residual),
        codes=codes.cpu().numpy(), **extra)


def load_pq(path, device=None) -> Tuple[PQCodebook, torch.Tensor]:
    """A codebook and codes saved by either package, on ``device``
    (default: the card)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        rot = (torch.as_tensor(z["rotation"], device=dev)
               if "rotation" in z else None)
        cb = PQCodebook(torch.as_tensor(z["centroids"], device=dev),
                        str(z["metric"]), bool(z["residual"]), rot)
        return cb, torch.as_tensor(z["codes"], device=dev)


def pq_decode(codes: torch.Tensor, cb: PQCodebook) -> torch.Tensor:
    """Codes -> reconstructed rows in the input space (OPQ codebooks undo
    the rotation; tests and diagnostics, not the serving path)."""
    m = cb.m
    parts = cb.centroids[torch.arange(m, device=codes.device)[None, :],
                         codes.long()]  # (N, M, ds)
    out = parts.reshape(codes.shape[0], cb.dim)
    if cb.rotation is None:
        return out
    ieee_f32()
    return out @ cb.rotation.T


def _adc_lut(q: torch.Tensor, cb: PQCodebook) -> torch.Tensor:
    """(Q, D) -> (Q, M, K) ADC table. Euclidean: ``||q_m - c_mk||^2`` at
    ``precision='default'`` (sums to the squared L2 to the
    reconstruction). Cosine: ``-(q_m . c_mk)`` in float32 on normalized
    queries (sums to -cos to the reconstruction; the +1 is added back in
    the reported values)."""
    qs = _split(q.float(), cb.m)  # (M, Q, ds)
    if cb.metric == "euclidean":
        lut = _batched_sq_l2(qs, cb.centroids)
    else:
        ieee_f32()
        lut = -torch.bmm(qs, cb.centroids.transpose(1, 2))
    return lut.permute(1, 0, 2)  # (Q, M, K)


def _pq_score(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The ADC sum: codes (Q, R, M) uint8, lut (Q, M, K) float32 ->
    (Q, R) float32, ``sum_m LUT[q, m, code_m]`` added in subspace order
    (one gather, then M - 1 adds; see the module note)."""
    terms = torch.gather(lut, 2, codes.permute(0, 2, 1).long())  # (Q, M, R)
    acc = terms[:, 0] + 0.0  # the scan's zero start
    for m in range(1, terms.shape[1]):
        acc = acc + terms[:, m]
    return acc


def _pq_finish(qf: torch.Tensor, approx: torch.Tensor, ids: torch.Tensor,
               rows: Optional[torch.Tensor], *, metric: str, k: int,
               rerank: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate (Q, R) scores and candidate ids -> top-k, reranked
    exactly (gallery-index tie order, the exact route's row forms) or in
    ADC units."""
    if rerank and rows is not None:
        r = min(rerank * k, ids.shape[1])
        order = torch.sort(approx, dim=1, stable=True).indices[:, :r]
        rid = torch.gather(ids, 1, order)
        rid = torch.sort(rid, dim=1).values  # exact ties by gallery index
        rrows = rows[torch.clamp(rid, max=n - 1).long()].float()
        qx = qf[:, None, :]
        exact = (euclidean_distance(qx, rrows) if metric == "euclidean"
                 else cosine_distance(qx, rrows))
        exact = torch.where(rid >= n, torch.inf, exact)
        fo = torch.sort(exact, dim=1, stable=True).indices[:, :k]
        return (torch.gather(exact, 1, fo),
                torch.gather(rid, 1, fo).to(torch.int32))
    order = torch.sort(approx, dim=1, stable=True).indices[:, :k]
    vals = torch.gather(approx, 1, order)
    if metric == "euclidean":
        vals = torch.sqrt(torch.clamp(vals, min=0.0))  # distance units
    else:
        vals = 1.0 + vals  # -cos -> cosine distance
    vals = torch.where(torch.isfinite(vals), vals, torch.inf)
    return vals, torch.gather(ids, 1, order).to(torch.int32)


def _ivf_pq_core(queries, centroids, row_ids, codes, cb_cent, rows,
                 rot=None, *, metric: str, k: int, nprobe: int, rerank: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw-row codes: one ADC table a query."""
    n = codes.shape[0]
    qf = queries.float()
    qp = _l2n(qf) if metric == "cosine" else qf
    probe = _probe(qp, centroids, metric, nprobe)
    ids = row_ids[probe].reshape(qf.shape[0], -1)
    ids = torch.sort(ids, dim=1).values  # pads (= n) last; ties by index
    cand = codes[torch.clamp(ids, max=n - 1).long()]  # (Q, R, M) uint8
    qa = qp if rot is None else _dot(qp, rot.T)  # OPQ: the rotated space
    lut = _adc_lut(qa, PQCodebook(cb_cent, metric))
    approx = torch.where(ids >= n, torch.inf, _pq_score(cand, lut))
    return _pq_finish(qf, approx, ids, rows, metric=metric, k=k,
                      rerank=rerank, n=n)


def _ivf_pq_residual_core(queries, centroids, row_ids, codes, cb_cent, rows,
                          rot=None, *, metric: str, k: int, nprobe: int,
                          rerank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual (FAISS ``by_residual``) scoring: a candidate's stored
    vector is ``c_probe + r``, exact a candidate since a row lies only in
    its own cluster's list. Euclidean builds one ADC table a (query,
    probe) over ``q - c_probe``; cosine one residual dot table a query
    plus the scalar ``q.c_probe``. Pure-mode ties break in probe-major
    candidate order; rerank mode re-sorts candidate ids."""
    n = codes.shape[0]
    qn = queries.shape[0]
    qf = queries.float()
    qp = _l2n(qf) if metric == "cosine" else qf
    probe = _probe(qp, centroids, metric, nprobe)  # (Q, P)
    ids = row_ids[probe]  # (Q, P, C)
    cand = codes[torch.clamp(ids, max=n - 1).reshape(qn * nprobe, -1)
                 .long()]  # (Q*P, C, M) uint8
    cp = centroids[probe]  # (Q, P, D)
    if metric == "euclidean":
        qr = qp[:, None, :] - cp
        if rot is not None:
            ieee_f32()
            qr = qr @ rot  # OPQ: the residual space is rotated
        lut = _adc_lut(qr.reshape(qn * nprobe, -1),
                       PQCodebook(cb_cent, "euclidean"))  # (Q*P, M, K)
        approx = _pq_score(cand, lut).reshape(qn, nprobe, -1)
    else:
        qa = qp if rot is None else _dot(qp, rot.T)  # q.r == qR.rR
        lut = _adc_lut(qa, PQCodebook(cb_cent, "cosine"))  # (Q, M, K)
        lutp = lut[:, None].expand(qn, nprobe, *lut.shape[1:]).reshape(
            qn * nprobe, *lut.shape[1:])
        ieee_f32()
        const = -torch.einsum("qd,qpd->qp", qp, cp)
        approx = (_pq_score(cand, lutp).reshape(qn, nprobe, -1)
                  + const[:, :, None])
    ids = ids.reshape(qn, -1)
    approx = torch.where(ids >= n, torch.inf, approx.reshape(qn, -1))
    return _pq_finish(qf, approx, ids, rows, metric=metric, k=k,
                      rerank=rerank, n=n)


def _chunk_queries(r: int, nprobe: int, cb: PQCodebook,
                   row_budget_bytes: int) -> int:
    """Queries a chunk: candidate codes (R, M), one (R, K) float32 scan
    step and the ADC table(s) a query (JAX's formula)."""
    per_q = (r * (cb.m + 4 * cb.k_codes)
             + nprobe * cb.m * cb.k_codes * 4)
    return max(1, int(row_budget_bytes // max(per_q, 1)))


def ivf_pq_search(queries: torch.Tensor, index: IVFIndex,
                  codes: torch.Tensor, cb: PQCodebook, *, nprobe: int = 8,
                  k: int = 10, rows: Optional[torch.Tensor] = None,
                  rerank_factor: int = 4, row_budget_bytes: int = 1 << 30
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k over the probed clusters -> (values, int32
    indices) on the codes' device.

    Pure-PQ mode (``rows=None``): values are distances to the PQ
    reconstruction, ordered by ADC with gallery-index ties. Rerank mode
    (``rows=`` the float32 or bf16 gallery): the best ``rerank_factor *
    k`` ADC candidates are re-scored exactly. Pad slots rank at +inf with
    index N."""
    if index.metric != cb.metric:
        raise ValueError(f"index metric {index.metric!r} != codebook "
                         f"metric {cb.metric!r}")
    if nprobe < 1:
        raise ValueError(f"nprobe must be >= 1, got {nprobe}")
    if rows is not None and rerank_factor < 1:
        raise ValueError("rerank_factor must be >= 1 when rows are given")
    nprobe = min(nprobe, index.nlist)
    n = int(codes.shape[0])
    r = nprobe * index.pad_width
    k = min(k, r, n)
    qc = _chunk_queries(r, nprobe, cb, row_budget_bytes)
    nq = queries.shape[0]
    if nq == 0:
        return _empty(k, codes.device)
    rerank = rerank_factor if rows is not None else 0
    core = _ivf_pq_residual_core if cb.residual else _ivf_pq_core
    queries = queries.to(codes.device)
    with torch.no_grad():
        outs = [core(queries[i: i + qc], index.centroids, index.row_ids,
                     codes, cb.centroids, rows, cb.rotation,
                     metric=cb.metric, k=k, nprobe=nprobe, rerank=rerank)
                for i in range(0, nq, qc)]
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def ivf_pq_search_sharded(queries: torch.Tensor, index: ShardedIVF, codes,
                          cb: PQCodebook, mesh, *,
                          axis_name: Optional[str] = None, nprobe: int = 8,
                          k: int = 10, rows=None, rerank_factor: int = 4,
                          row_budget_bytes: int = 1 << 30
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ over a row-sharded gallery -> (values, GLOBAL int32
    indices) on ``mesh.devices[0]``. Each shard probes its local
    clusters, ADC-scores its own codes, optionally reranks its best
    candidates exactly on its own rows, and the (Q, k) partials merge by
    (value, global index): full probe with a rerank covering every
    candidate equals the exact route. ``codes`` and ``rows``: (N, ...) or
    S row shards."""
    if not isinstance(index, ShardedIVF):
        raise ValueError("ivf_pq_search_sharded needs a ShardedIVF")
    if index.metric != cb.metric:
        raise ValueError(f"index metric {index.metric!r} != codebook "
                         f"metric {cb.metric!r}")
    if nprobe < 1:
        raise ValueError(f"nprobe must be >= 1, got {nprobe}")
    if rows is not None and rerank_factor < 1:
        raise ValueError("rerank_factor must be >= 1 when rows are given")
    ax = axis_name or mesh.axis_name
    n_dev = mesh.size
    if n_dev != index.n_shards:
        raise ValueError(f"index built for {index.n_shards} shards, mesh "
                         f"'{ax}' axis has {n_dev}")
    n = _n_rows(codes)
    if n != n_dev * index.n_local:
        raise ValueError(f"codes rows ({n}) != n_shards*n_local "
                         f"({n_dev}*{index.n_local})")
    if rows is not None and _n_rows(rows) != n:
        raise ValueError(f"rows ({_n_rows(rows)}) must shard like the "
                         f"codes ({n})")
    if k > index.n_local:
        raise ValueError(f"k={k} exceeds the per-shard gallery size "
                         f"{index.n_local}; shrink the mesh axis or pad "
                         "the gallery")
    nprobe = min(nprobe, index.nlist)
    r = nprobe * index.pad_width
    k = min(k, r, index.n_local)
    qc = _chunk_queries(r, nprobe, cb, row_budget_bytes)
    nq = queries.shape[0]
    if nq == 0:
        return _empty(k, mesh.devices[0])
    rerank = rerank_factor if rows is not None else 0
    core_fn = _ivf_pq_residual_core if cb.residual else _ivf_pq_core
    cents = _per_shard(index.centroids, mesh)
    tabs = _per_shard(index.row_ids, mesh)
    code_s = _row_shards(codes, mesh)
    row_s = _row_shards(rows, mesh) if rows is not None else None
    cbs = [_codebook_on(cb, d) for d in mesh.devices]

    def core(s, q):
        return core_fn(q, cents[s], tabs[s], code_s[s], cbs[s].centroids,
                       row_s[s] if row_s is not None else None,
                       cbs[s].rotation, metric=cb.metric, k=k,
                       nprobe=nprobe, rerank=rerank)

    with torch.no_grad():
        outs = [_sharded_core(queries[i: i + qc].float(), mesh,
                              index.n_local, k, core)
                for i in range(0, nq, qc)]
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))
