"""The merge of the row-sharded retrieval routes.

Counterpart of ``art_sbir_tpu/ops/sharded.py``. Each sharded route here
(K1's sweep in ``retrieval_fused.py``, the int8 scan in ``quant.py``, the
serving engine's exact route) ranks each shard's rows on its own device
and brings a ``(Q, k)`` partial with GLOBAL indices to the mesh's first
device; this merge takes each query's ``k`` smallest by (value, global
index). That is the cross-route tie order of the single-device path, so
it lives here once. :func:`merge_shard_runs_reference` is the plain
version of K1's cross-shard merge kernel (``k1_merge_runs`` in
``csrc/fused_retrieval.cu``, launched by ``ops/retrieval_fused.py::
merge_shard_runs``): the same merge, with the rank partials summed and
the certificates ANDed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def lexsort_topk_merge(part_vals: torch.Tensor, part_idx: torch.Tensor,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, Q, k) partials -> the global (Q, k) top-k.

    ``part_vals`` / ``part_idx``: (S, Q, k) on one device, values
    ascending per shard, indices global, unfilled slots at a sentinel that
    sorts last (such as ``N``). Torch has no lexsort: a stable sort by
    index, then a stable sort by value, orders by (value, index)."""
    nq = part_vals.shape[1]
    vals = part_vals.movedim(0, 1).reshape(nq, -1)
    idx = part_idx.movedim(0, 1).reshape(nq, -1)
    by_idx = torch.argsort(idx, dim=1, stable=True)
    vals, idx = torch.gather(vals, 1, by_idx), torch.gather(idx, 1, by_idx)
    order = torch.argsort(vals, dim=1, stable=True)[:, :k]
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


def gather_to(parts: Sequence[torch.Tensor], device: torch.device
              ) -> torch.Tensor:
    """Stack per-shard tensors of one shape on ``device``: (S, ...)."""
    return torch.stack([p.to(device) for p in parts])


def merge_shard_runs_reference(vals: torch.Tensor, idx: torch.Tensor, k: int,
                               n: int, ranks: Optional[torch.Tensor] = None,
                               exact: Optional[torch.Tensor] = None,
                               out=None):
    """(ranks, vals, idx, exact) of S runs a query: ``vals`` and ``idx``
    (S, Q, L) on one device, each run ascending by (value, global index),
    S * L >= k; ``ranks`` and ``exact`` (S, Q) int32 or None; ``n`` the
    gallery's rows (the kernel's sentinel index; the runs' own unfilled
    slots sort last here). The k smallest by (value, index)
    (:func:`lexsort_topk_merge`), the sum of the rank partials (None
    without them) and the AND of the certificates (1 without them), as
    int32; written into ``out`` (ranks, vals, idx, exact) where given."""
    vals, idx = lexsort_topk_merge(vals, idx, k)
    nq = vals.shape[0]
    if ranks is not None:
        ranks = ranks.sum(0, dtype=torch.int32)
    exact = (torch.ones(nq, dtype=torch.int32, device=vals.device)
             if exact is None else (exact != 0).all(0).to(torch.int32))
    return fill(out, (ranks, vals, idx, exact))


def fill(out, got):
    """``got`` copied into ``out`` (skipping None), or ``got`` where
    ``out`` is None."""
    if out is None:
        return got
    for o, g in zip(out, got):
        if g is not None:
            o.copy_(g)
    return tuple(o if g is not None else None for o, g in zip(out, got))


def record_words(q: int, k: int) -> int:
    """int32 words of one device's result record: (Q, k) values and
    indices, (Q,) ranks and certificates."""
    return q * (2 * k + 2)


def record_views(buf: torch.Tensor, q: int, k: int):
    """(ranks, vals, idx, exact) views of the int32 records ``buf``
    (..., :func:`record_words`): ranks and exact (..., Q), vals (...,
    Q, k) float32, idx (..., Q, k). A device writes its result into one
    record, and one copy takes it to the first device, whose merge reads
    every device's record in place."""
    a = q * k
    lead = buf.shape[:-1]
    return (buf[..., 2 * a:2 * a + q],
            buf[..., :a].view(torch.float32).view(*lead, q, k),
            buf[..., a:2 * a].view(*lead, q, k),
            buf[..., 2 * a + q:2 * a + 2 * q])


def pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes in one uint8 buffer on their device, each part
    at a 16-byte boundary: one copy sends them all to another device."""
    sizes = [t.numel() * t.element_size() for t in tensors]
    starts = [0]
    for b in sizes:
        starts.append(starts[-1] + -(-b // 16) * 16)
    blob = torch.empty(starts[-1], dtype=torch.uint8,
                       device=tensors[0].device)
    for t, a, b in zip(tensors, starts, sizes):
        blob[a:a + b].view(t.dtype).view(t.shape).copy_(t)
    return blob


def unpack(blob: torch.Tensor, like: Sequence[torch.Tensor]):
    """Views of :func:`pack`'s buffer (on any device) as tensors of the
    types and shapes of ``like``."""
    out, a = [], 0
    for t in like:
        b = t.numel() * t.element_size()
        out.append(blob[a:a + b].view(t.dtype).view(t.shape))
        a += -(-b // 16) * 16
    return out


def device_groups(mesh) -> List[Tuple[torch.device, List[int]]]:
    """The mesh's shards by device: (device, shard numbers), each device
    once, in mesh order (the first device first)."""
    groups = {}
    for i, d in enumerate(mesh.devices):
        groups.setdefault(d, []).append(i)
    return list(groups.items())
