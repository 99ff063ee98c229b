"""Int8-quantized retrieval with exact re-ranking.

Counterpart of ``art_sbir_tpu/ops/quant.py``, with its contract:

* Euclidean: ``d^2 = |q|^2 - 2 q.g + |g|^2``. The row norms ``|g|^2`` are
  exact float32 sums taken at quantization time and ``|q|^2`` is
  rank-constant, so only the cross term is approximated, as ``q.g ~= s_q *
  s_g * (q8 . g8)`` with symmetric per-row scales ``s = max|x| / 127`` and
  an exact integer sum of int8 products.
* Cosine: rows are L2-normalized before quantization, so the same int8 dot
  approximates the cosine similarity and ``-dot`` ranks like ``1 - sim``.
* Candidates: the ``rerank_factor * k`` best rows by the approximate score
  (the earlier index wins ties, as ``lax.top_k``), sorted by gallery index,
  then re-ranked exactly on the gathered float32 rows with the library
  row-wise distances and a stable sort, so exact-distance ties rank by
  gallery index as on the exact route.

The candidate scan runs through :mod:`art_sbir_tpu_torch.ops.quant_fused`:
its plain version inside :func:`retrieve_quantized`, and K2 (CUDA) on the
card inside :func:`retrieve_quantized_fused` and, on each shard of a
row-sharded gallery, :func:`retrieve_quantized_sharded`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from art_sbir_tpu_torch.ops import quant_fused
from art_sbir_tpu_torch.ops.distance import cosine_distance, euclidean_distance
from art_sbir_tpu_torch.ops.retrieval_fused import merge_shard_runs
from art_sbir_tpu_torch.ops.sharded import (device_groups, pack,
                                            record_views, record_words,
                                            unpack)
from art_sbir_tpu_torch.parallel.mesh import shard_rows

_METRICS = ("euclidean", "cosine")
# The streamed route's largest candidate budget: the JAX package's, whose
# kernel holds 8 * 128 candidates at its default depth
R_CAP = 8 * 128


class QuantGallery(NamedTuple):
    """Int8 gallery + exact float32 row norms (euclidean) or zeros
    (cosine)."""

    q8: torch.Tensor       # (N, D) int8
    scale: torch.Tensor    # (N,) float32 per-row symmetric scale
    sq_norm: torch.Tensor  # (N,) float32 exact |g|^2 (zeros for cosine)
    metric: str


def _symmetric_quantize(rows: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows,) -> (int8 rows, per-row scale), symmetric max-abs/127, round
    half to even as ``jnp.round``."""
    scale = torch.clamp(torch.amax(torch.abs(rows), dim=1), min=1e-12) / 127.0
    q8 = torch.clamp(torch.round(rows / scale[:, None]), -127, 127)
    return q8.to(torch.int8), scale


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-12)


def quantize_gallery(gallery: torch.Tensor, metric: str = "euclidean"
                     ) -> QuantGallery:
    """Symmetric per-row int8 quantization; cosine pre-normalizes rows."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}; one of {_METRICS}")
    with torch.no_grad():
        g = gallery.float()
        if metric == "cosine":
            g = _l2_normalize(g)
        q8, scale = _symmetric_quantize(g)
        sq = (torch.sum(g * g, dim=1) if metric == "euclidean"
              else torch.zeros(g.shape[0], dtype=torch.float32,
                               device=g.device))
    return QuantGallery(q8, scale, sq, metric)


def _quantize_queries(qf: torch.Tensor, metric: str):
    return _symmetric_quantize(_l2_normalize(qf) if metric == "cosine"
                               else qf)


def _quant_core(queries: torch.Tensor, g8: torch.Tensor,
                g_scale: torch.Tensor, g_sq: torch.Tensor,
                gallery_f32: torch.Tensor, *, metric: str, k: int, r: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain int8 scan: top-``r`` candidates by approximate score,
    sorted by gallery index, then the exact rerank."""
    with torch.no_grad():
        qf = queries.float()
        q8, s_q = _quantize_queries(qf, metric)
        _, cand, _ = quant_fused.quant_candidates_reference(
            q8, s_q, g8, g_scale, g_sq, r=r, metric=metric)
        cand = torch.sort(cand, dim=1).values
        return _rerank(qf, cand, gallery_f32, metric, k)


def _rerank(qf, cand, gallery_f32, metric, k):
    """Exact rerank of index-sorted candidates on gathered float32 rows
    (stable argsort: ties by gallery index).

    Gather FIRST, cast the (Q, R, D) rows after: casting a bf16-resident
    gallery before the gather would materialize a full float32 copy of it
    on every call."""
    rows = gallery_f32[cand.long()].float()
    qx = qf[:, None, :]  # un-normalized, like the exact path
    if metric == "euclidean":
        exact = euclidean_distance(qx, rows)
    else:
        exact = cosine_distance(qx, rows)
    order = torch.argsort(exact, dim=1, stable=True)[:, :k]
    return torch.gather(exact, 1, order), torch.gather(cand, 1, order)


def _row_span(rows, row0):
    """One (rows, D) view from ``row0[0]`` over the shards ``rows`` (first
    global rows ``row0``, ascending) where they lie in one storage at
    their global distances, as shards cut from one gallery do; else
    None."""
    first, nl = rows[0], rows[0].shape[0]
    step = first.stride(0) * first.element_size()
    base = first.untyped_storage().data_ptr()
    if not all(t.is_contiguous() and t.untyped_storage().data_ptr() == base
               and t.data_ptr() - first.data_ptr() == (r - row0[0]) * step
               for t, r in zip(rows, row0)):
        return None
    return torch.as_strided(first, (row0[-1] - row0[0] + nl, first.shape[1]),
                            first.stride())


def _rerank_shards(qf, cand, rows, row0, metric, k):
    """:func:`_rerank` of each of C shards at once: ``cand`` (Q, C, r)
    global rows, each shard's in index order; ``rows`` the shards' rerank
    rows, first global rows ``row0``. Returns each shard's (Q, C, k) best
    by exact distance, ties by index. The distances are ``_rerank``'s
    row-wise reductions over D, with Q * C * r outputs in place of Q * r
    (``chip_smoke.py`` holds the two to the bit on the card)."""
    span = _row_span(rows, row0)
    if span is not None:
        sel = span[(cand - row0[0]).long() if row0[0] else cand.long()]
    else:
        sel = torch.stack([t[(cand[:, j] - first).long()]
                           for j, (t, first) in enumerate(zip(rows, row0))],
                          1)
    sel = sel.float()
    qx = qf[:, None, None, :]
    exact = (euclidean_distance(qx, sel) if metric == "euclidean"
             else cosine_distance(qx, sel))
    order = torch.argsort(exact, dim=2, stable=True)[..., :k]
    return torch.gather(exact, 2, order), torch.gather(cand, 2, order)


def retrieve_quantized(queries: torch.Tensor, qg: QuantGallery,
                       gallery_f32: torch.Tensor, k: int = 10,
                       rerank_factor: int = 8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-k values, int32 indices): int8 candidate scan + exact float32
    rerank. ``gallery_f32`` (float32 or bf16 rows) is used only for the
    (Q, R, D) candidate gather, R = ``rerank_factor * k``. Values match the
    exact path's contract (eps-folded distances / 1 - cos)."""
    k = min(k, qg.q8.shape[0])
    r = min(max(rerank_factor * k, k), qg.q8.shape[0])
    return _quant_core(queries, qg.q8, qg.scale, qg.sq_norm, gallery_f32,
                       metric=qg.metric, k=k, r=r)


def retrieve_quantized_chunked(queries: torch.Tensor, qg: QuantGallery,
                               gallery_f32: torch.Tensor, k: int = 10,
                               rerank_factor: int = 8, chunk: int = 256
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-chunked :func:`retrieve_quantized`: each chunk materializes a
    (chunk, N) approximate-score matrix instead of a (Q, N) one."""
    nq = queries.shape[0]
    if nq == 0:
        ke = min(k, qg.q8.shape[0])
        dev = qg.q8.device
        return (torch.zeros((0, ke), dtype=torch.float32, device=dev),
                torch.zeros((0, ke), dtype=torch.int32, device=dev))
    outs = [retrieve_quantized(queries[i:i + chunk], qg, gallery_f32, k=k,
                               rerank_factor=rerank_factor)
            for i in range(0, nq, chunk)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def retrieve_quantized_fused(queries: torch.Tensor, qg: QuantGallery,
                             gallery_f32: torch.Tensor, k: int = 10,
                             rerank_factor: int = 8,
                             device_get: bool = False):
    """Streamed int8 candidate scan (K2 on the card) + exact float32 rerank.

    Same contract as :func:`retrieve_quantized`, with O(Q) state instead
    of the (Q, N) approximate-score matrix, and at most ``R_CAP``
    candidates. Rows whose certificate failed are recomputed with
    :func:`retrieve_quantized`, padded to a power of two, and counted in
    ``quant_fused.counters.fallback_rows``; K2 is exact by construction
    and certifies every row. ``device_get=True`` returns numpy arrays."""
    n = qg.q8.shape[0]
    k = min(k, n)
    r = min(max(rerank_factor * k, k), n, R_CAP)
    with torch.no_grad():
        qf = queries.float()
        q8, s_q = _quantize_queries(qf, qg.metric)
        _, cand, cert = quant_fused.quant_candidates_fused(
            q8, s_q, qg.q8, qg.scale, qg.sq_norm, r=r, metric=qg.metric)
        cand = torch.sort(cand, dim=1).values
        vals, idx = _rerank(qf, cand, gallery_f32, qg.metric, k)
    if device_get:
        vals, idx, cert_h = (t.cpu().numpy() for t in (vals, idx, cert))
    else:
        cert_h = cert.cpu().numpy()
    if cert_h.all():
        return vals, idx
    bad = np.nonzero(cert_h == 0)[0]
    nbad = len(bad)
    quant_fused.counters.add(fallback_rows=nbad)
    pad = 1 << (nbad - 1).bit_length() if nbad > 1 else 1
    pad = min(pad, qf.shape[0])
    sel = np.pad(bad, (0, pad - nbad), mode="edge")
    vb, ib = retrieve_quantized(
        queries[torch.as_tensor(sel, device=queries.device)], qg,
        gallery_f32, k=k, rerank_factor=rerank_factor)
    if device_get:
        vals[bad] = vb[:nbad].cpu().numpy()
        idx[bad] = ib[:nbad].cpu().numpy()
        return vals, idx
    bad_t = torch.as_tensor(bad, device=vals.device)
    vals[bad_t] = vb[:nbad]
    idx[bad_t] = ib[:nbad]
    return vals, idx


def shard_quant_gallery(qg, gallery_f32, mesh):
    """(QuantGallery shards, rerank-row shards), shard ``i`` on
    ``mesh.devices[i]``: contiguous ``N / S`` rows of a whole
    :class:`QuantGallery` and its rerank rows, or sequences of S shards
    already placed (returned as lists)."""
    if isinstance(qg, QuantGallery):
        qg = [QuantGallery(*parts, qg.metric) for parts in zip(
            shard_rows(qg.q8, mesh), shard_rows(qg.scale, mesh),
            shard_rows(qg.sq_norm, mesh))]
    if isinstance(gallery_f32, torch.Tensor):
        gallery_f32 = shard_rows(gallery_f32, mesh)
    qg, gallery_f32 = list(qg), list(gallery_f32)
    if len(qg) != mesh.size or len(gallery_f32) != mesh.size:
        raise ValueError(f"want {mesh.size} shards, got {len(qg)} int8 and "
                         f"{len(gallery_f32)} rerank shards")
    return qg, gallery_f32


def retrieve_quantized_sharded(queries: torch.Tensor, qg, gallery_f32, mesh,
                               k: int = 10, rerank_factor: int = 4,
                               use_kernel: bool | None = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-k values, int32 global indices) on ``mesh.devices[0]``: the
    int8 route over a row-sharded gallery. ``qg`` and ``gallery_f32`` as
    :func:`shard_quant_gallery` takes them.

    The queries are quantized once and sent once to each device. Each
    shard scans ITS rows for its own top-``r``, ``r = min(max(rerank_factor
    * k, k), N / S)``, on its own device, and reranks those candidates
    exactly on its own rows. Where ``use_kernel`` (default: where
    :func:`~art_sbir_tpu_torch.ops.quant_fused.kernel_takes` every shard's
    device, ``r`` and D), the shards that share a device are one K2 launch
    (:func:`~art_sbir_tpu_torch.ops.quant_fused.quant_candidates_shards`,
    the candidates in index order as global rows) and one rerank
    (:func:`_rerank_shards`); else each shard takes the plain int8 scan and
    :func:`_rerank` (the per-shard plain route). The shards' (Q, k) runs
    merge by (value, index), the certificates ANDed
    (:func:`~art_sbir_tpu_torch.ops.retrieval_fused.merge_shard_runs`: K1's
    merge kernel on the card): once on a one-device mesh; over several
    devices, each device's on the device into a record that one copy
    takes to the first device, where the records merge. The certificates
    are read once.

    Contract: "per-shard top-r + local exact rerank + merge", a superset
    of the single-device candidate set (each global top-r candidate is in
    its shard's top-r), so it equals :func:`retrieve_quantized` on
    separated data and may differ (for the better) elsewhere. Rows whose
    K2 certificate failed are recomputed with ``use_kernel=False``, padded
    to a power of two, and counted in ``quant_fused.counters``."""
    sizes = ([int(qg.q8.shape[0])] if isinstance(qg, QuantGallery)
             else [int(s.q8.shape[0]) for s in qg])
    n = sum(sizes)
    nl = n // mesh.size
    if n % mesh.size or (len(sizes) > 1 and set(sizes) != {nl}):
        raise ValueError(
            f"gallery rows ({n}) must be divisible by the "
            f"'{mesh.axis_name}' mesh axis ({mesh.size}); pad the gallery "
            "(parallel.mesh.pad_to_multiple)")
    if k > nl:
        raise ValueError(
            f"k={k} exceeds the per-shard gallery size {nl}; shrink the "
            "mesh axis or pad the gallery")
    qg, gallery_f32 = shard_quant_gallery(qg, gallery_f32, mesh)
    r = min(max(rerank_factor * k, k), nl)
    metric = qg[0].metric
    dev0 = mesh.devices[0]
    kernel = (all(quant_fused.kernel_takes(d, r, int(s.q8.shape[1]))
                  for d, s in zip(mesh.devices, qg))
              if use_kernel is None else bool(use_kernel))
    with torch.no_grad():
        qf = queries.to(dev0).float()
        q8, s_q = _quantize_queries(qf, metric)
        groups = device_groups(mesh)
        # the queries reach every card, in one copy, before any shard's
        # kernel is queued (a copy between cards runs behind the source
        # card's queued work)
        inputs = [qf, q8, s_q]
        blob = pack(inputs) if len(groups) > 1 else None
        sent = [unpack(blob.to(d), inputs) if blob is not None else inputs
                for d, _ in groups]
        nq, words = qf.shape[0], record_words(qf.shape[0], k)
        records = (torch.empty((len(groups), words), dtype=torch.int32,
                               device=dev0) if len(groups) > 1 else None)
        local = []
        for j, ((d, members), (qf_d, q8_d, s_q_d)) in enumerate(
                zip(groups, sent)):
            row0 = [i * nl for i in members]
            if kernel:
                _, cand, c = quant_fused.quant_candidates_shards(
                    q8_d, s_q_d, [qg[i] for i in members], row0, r=r,
                    metric=metric)
                v, il = _rerank_shards(qf_d, cand,
                                       [gallery_f32[i] for i in members],
                                       row0, metric, k)
            else:
                parts = []
                for i, first in zip(members, row0):
                    _, cand, _ = quant_fused.quant_candidates_reference(
                        q8_d, s_q_d, qg[i].q8, qg[i].scale, qg[i].sq_norm,
                        r=r, metric=metric)
                    cand = torch.sort(cand, dim=1).values
                    parts.append(_rerank(qf_d, cand, gallery_f32[i], metric,
                                         k))
                v = torch.stack([pv for pv, _ in parts], 1)
                il = torch.stack([pi + first for (_, pi), first
                                  in zip(parts, row0)], 1)
                c = torch.ones((len(members), qf_d.shape[0]),
                               dtype=torch.int32, device=d)
            # the device's (Q, C, k) runs as (C, Q, k): one run a shard
            out = None
            if records is not None:
                rec = records[0] if j == 0 else torch.empty(
                    words, dtype=torch.int32, device=d)
                local.append(rec)
                out = record_views(rec, nq, k)
            _, vals, idx, cert = merge_shard_runs(
                v.transpose(0, 1), il.transpose(0, 1), k, n, exact=c,
                out=out)
        if records is not None:  # the devices' records, merged on the first
            for j in range(1, len(groups)):
                records[j].copy_(local[j])
            _, v, il, c = record_views(records, nq, k)
            _, vals, idx, cert = merge_shard_runs(v, il, k, n, exact=c)
        cert_h = cert.cpu().numpy()
    if cert_h.all() or not kernel:
        return vals, idx
    bad = np.nonzero(cert_h == 0)[0]
    nbad = len(bad)
    quant_fused.counters.add(fallback_rows=nbad)
    pad = 1 << (nbad - 1).bit_length() if nbad > 1 else 1
    pad = min(pad, qf.shape[0])
    sel = torch.as_tensor(np.pad(bad, (0, pad - nbad), mode="edge"),
                          device=dev0)
    vb, ib = retrieve_quantized_sharded(
        qf[sel], qg, gallery_f32, mesh, k=k, rerank_factor=rerank_factor,
        use_kernel=False)
    bad_t = torch.as_tensor(bad, device=dev0)
    vals[bad_t] = vb[:nbad]
    idx[bad_t] = ib[:nbad]
    return vals, idx


def topk_overlap(idx_a, idx_b) -> float:
    """Mean per-query overlap |A ∩ B| / k between two (Q, k) index sets —
    the recall-quality metric for approximate modes."""
    a, b = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (idx_a, idx_b))
    inter = [len(set(ra) & set(rb)) for ra, rb in zip(a, b)]
    return float(np.mean(inter)) / a.shape[1]
