"""Distances, ranking and top-k retrieval: the exact route.

Counterpart of ``art_sbir_tpu/ops/distance.py`` with the same semantics:

* ``euclidean``: ``torch.nn.PairwiseDistance(p=2)``, ``||a - b + eps||_2``
  with ``eps=1e-6`` folded into the difference; the pairwise form expands
  it as ``|q|^2 + |g|^2 - 2 q.g + 2 eps (sum q - sum g) + D eps^2``, in
  that op order (the fused kernel folds eps differently, so each route
  keeps its own order).
* ``cosine``: ``1 - cosine_similarity``, denominators clamped at 1e-8.
* rank of the positive: gallery items strictly closer, plus exact ties at
  a smaller gallery index.
* top-k: ascending, ties broken by the smaller gallery index. ``torch.topk``
  leaves the order among ties unspecified, so a stable sort is used.

``precision='highest'`` is IEEE float32 (TF32 off); ``'default'`` rounds
both operands of the cross term to bfloat16 and accumulates in float32,
as the JAX package's bf16 matrix passes do.
"""

from __future__ import annotations

from typing import Tuple

import torch

from art_sbir_tpu_torch.core.device import ieee_f32

PAIRWISE_EPS = 1e-6  # torch.nn.PairwiseDistance default
COSINE_EPS = 1e-8  # torch.nn.CosineSimilarity default


def euclidean_distance(a: torch.Tensor, b: torch.Tensor,
                       eps: float = PAIRWISE_EPS) -> torch.Tensor:
    """Row-wise ``||a - b + eps||_2`` (broadcasting)."""
    return torch.sqrt(torch.sum(torch.square(a - b + eps), dim=-1))


def cosine_distance(a: torch.Tensor, b: torch.Tensor,
                    eps: float = COSINE_EPS) -> torch.Tensor:
    """Row-wise ``1 - cos_sim`` in [0, 2] (broadcasting)."""
    na = torch.linalg.vector_norm(a, dim=-1)
    nb = torch.linalg.vector_norm(b, dim=-1)
    dot = torch.sum(a * b, dim=-1)
    return 1.0 - dot / torch.clamp(na * nb, min=eps)


def _cross(q: torch.Tensor, g: torch.Tensor, precision: str) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) float32 cross term."""
    if precision == "highest":
        ieee_f32()
    elif precision == "default":
        q = q.to(torch.bfloat16).float()
        g = g.to(torch.bfloat16).float()
    else:
        raise ValueError(f"unknown precision {precision!r} (highest|default)")
    return q @ g.T


def pairwise_sq_l2(q: torch.Tensor, g: torch.Tensor, eps: float = 0.0,
                   precision: str = "highest") -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) squared L2 distances (see module doc)."""
    q = q.float()
    g = g.float()
    qq = torch.sum(q * q, dim=-1, keepdim=True)  # (Q, 1)
    gg = torch.sum(g * g, dim=-1)  # (N,)
    cross = _cross(q, g, precision)
    d2 = qq + gg[None, :] - 2.0 * cross
    if eps:
        d = q.shape[-1]
        corr = 2.0 * eps * (torch.sum(q, -1, keepdim=True)
                            - torch.sum(g, -1)[None, :])
        d2 = d2 + corr + d * eps * eps
    return torch.clamp(d2, min=0.0)


def pairwise_l2(q: torch.Tensor, g: torch.Tensor, eps: float = PAIRWISE_EPS,
                precision: str = "highest") -> torch.Tensor:
    return torch.sqrt(pairwise_sq_l2(q, g, eps=eps, precision=precision))


def pairwise_cosine(q: torch.Tensor, g: torch.Tensor, eps: float = COSINE_EPS,
                    precision: str = "highest") -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) cosine distances."""
    q = q.float()
    g = g.float()
    nq = torch.linalg.vector_norm(q, dim=-1, keepdim=True)  # (Q, 1)
    ng = torch.linalg.vector_norm(g, dim=-1)  # (N,)
    dot = _cross(q, g, precision)
    return 1.0 - dot / torch.clamp(nq * ng[None, :], min=eps)


def pairwise_distance(q: torch.Tensor, g: torch.Tensor,
                      metric: str = "euclidean",
                      precision: str = "highest") -> torch.Tensor:
    if metric == "euclidean":
        return pairwise_l2(q, g, precision=precision)
    if metric == "cosine":
        return pairwise_cosine(q, g, precision=precision)
    raise ValueError(f"unknown metric {metric!r} (euclidean|cosine)")


def rank_of_positive(dist: torch.Tensor, pos_idx: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """0-based rank of the positive gallery item per query, int32.

    ``dist`` (Q, N), ``pos_idx`` (Q,). Ties at exactly the positive's
    distance count when they sit at a smaller gallery index.
    ``valid`` (N,) optionally masks padded gallery rows."""
    n = dist.shape[-1]
    pos = pos_idx.long()[:, None]
    d_pos = torch.gather(dist, -1, pos)  # (Q, 1)
    idx = torch.arange(n, device=dist.device)[None, :]
    hit = (dist < d_pos) | ((dist == d_pos) & (idx < pos))
    if valid is not None:
        hit = hit & valid[None, :]
    return torch.sum(hit, dim=-1).to(torch.int32)


def top_k(dist: torch.Tensor, k: int, valid: torch.Tensor | None = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k distances per row -> (values, int32 indices), ascending,
    equal values in gallery-index order. Masked rows become ``+inf``.
    ``k`` is clamped to the gallery size."""
    if valid is not None:
        dist = torch.where(valid[None, :], dist, torch.inf)
    k = min(k, dist.shape[-1])
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def retrieve(queries: torch.Tensor, gallery: torch.Tensor,
             pos_idx: torch.Tensor, k: int = 10, metric: str = "euclidean",
             valid: torch.Tensor | None = None, precision: str = "highest"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched retrieval: (ranks, topk_values, topk_indices)."""
    dist = pairwise_distance(queries, gallery, metric, precision)
    ranks = rank_of_positive(dist, pos_idx, valid)
    vals, idx = top_k(dist, k, valid)
    return ranks, vals, idx


def retrieve_chunked(queries: torch.Tensor, gallery: torch.Tensor,
                     pos_idx: torch.Tensor, k: int = 10,
                     metric: str = "euclidean", precision: str = "highest",
                     chunk: int = 256
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Query-chunked :func:`retrieve`: each chunk materializes a
    (chunk, N) distance matrix instead of the full (Q, N) one. The exact
    fallback behind the fused kernel's certificate."""
    outs = [retrieve(queries[i:i + chunk], gallery, pos_idx[i:i + chunk],
                     k=k, metric=metric, precision=precision)
            for i in range(0, queries.shape[0], chunk)]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))
