"""The merge of the row-sharded retrieval routes.

Counterpart of ``art_sbir_tpu/ops/sharded.py``. Each sharded route here
(K1's sweep in ``retrieval_fused.py``, the int8 scan in ``quant.py``, the
serving engine's exact route) ranks each shard's rows on its own device
and brings a ``(Q, k)`` partial with GLOBAL indices to the mesh's first
device; this merge takes each query's ``k`` smallest by (value, global
index). That is the cross-route tie order of the single-device path, so
it lives here once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

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
