"""K1: fused pairwise distance + rank-of-positive + top-k over the gallery.

Counterpart of ``art_sbir_tpu/ops/retrieval_pallas.py`` (the forms of
``_kernel``: float32 operands under ``precision='highest'``, the bf16
gallery stream under ``'default'``, each on one device or over a
row-sharded gallery, :func:`retrieve_fused_sharded`). The kernel is hand-written CUDA
for Hopper, ``csrc/fused_retrieval.cu``; its note says what bounds it and
how it is built. It is compiled with ``nvcc`` at first use into
``art_sbir_tpu_torch/_build/`` and loaded with ``ctypes``.

Under ``'default'`` only the cross term sees bf16 operands: the queries
and the gallery are rounded to bf16 (no copy for a gallery the caller
already holds in bf16), their products are exact in float32 and summed in
float32 (the CUDA kernel on the tensor cores, whose sum order and rounding
inside an instruction are the hardware's: :func:`sum_order_bound` bounds
how far that moves a distance). The norms come from the caller's arrays in
float32, as the TPU
kernel's ``_prep_norms`` takes them before ``_sweep`` casts, so an
engine's cached gallery norms serve both forms.

Contract (as the TPU kernel's): squared eps-folded euclidean distances
(``qq' = |q|^2 + 2 eps sum q + D eps^2``, ``gg' = |g|^2 - 2 eps sum g``,
``d = max(qq' + gg' - 2 q.g, 0)``) or cosine ``1 - q.g / max(|q||g|,
1e-8)``; the rank of the positive counts columns strictly closer than the
positive's own distance plus exact ties at a smaller index, never the
positive's column; the top-k is ascending with the earliest column
winning ties; the sentinel is value 3e38 at index N.

One difference from the TPU kernel: the positive's distance comes from the
same arithmetic as its column in each route (the plain version gathers it
from its distance matrix, the CUDA kernel computes it with the sweep's own
FMA chain or tensor-core instruction), not from a separate elementwise
sum, so a duplicate of the
positive ties with it exactly, as in ``ops/distance.py::rank_of_positive``.
On the CPU, ``torch.sum`` and ``torch.matmul`` round the same dot product
differently, so an elementwise sum would miss such ties that the JAX
package's kernel finds. Under ``'default'`` the rule is the same, so the
positive's distance has bf16 operands like its column; the TPU kernel
takes it from the float32 inputs. Ranks then agree where no other column
lies within the bf16 rounding of the positive's distance (separated data),
and may differ by a few columns where some do.

:func:`fused_sweep` runs the plain PyTorch version for a tensor on the
CPU and the CUDA kernel for a tensor on the card; there is no fallback
between them. The CUDA kernel is exact by construction and reports
``exact = 1`` on every row; :func:`retrieve_fused` keeps the per-row
certificate contract all the same and recomputes flagged rows with
:func:`~art_sbir_tpu_torch.ops.distance.retrieve_chunked`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from art_sbir_tpu_torch.core.cuda_build import (CudaKernel, LaunchCounters,
                                                Plans, grid_splits, scratch,
                                                signature)
from art_sbir_tpu_torch.ops.distance import (COSINE_EPS, PAIRWISE_EPS,
                                             _cross, retrieve_chunked)
from art_sbir_tpu_torch.ops.sharded import (device_groups, gather_to,
                                            merge_shard_runs_reference, pack,
                                            record_views, record_words,
                                            unpack)
from art_sbir_tpu_torch.parallel.mesh import shard_rows

BIG = 3.0e38  # sentinel value: worse than any distance
K_MAX = 128
_METRICS = {"euclidean": 0, "cosine": 1}

_OPERANDS = {"highest": torch.float32, "default": torch.bfloat16}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte load

_ptr, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("fused_retrieval", "k1_fused_retrieval",
                    [_ptr] * 5 + [_i32] * 8 + [_ptr] * 8 + [_ptr], label="K1")
# the entries of the row-sharded gallery (shards that share a device are
# one launch; their pointers go as host arrays)
POSITIVE_ARGTYPES = [_ptr] * 6 + [_i32] * 7 + [_ptr] * 2
SWEEP_ARGTYPES = [_ptr] * 6 + [_i32] * 10 + [_ptr] * 9
MERGE_ARGTYPES = [_ptr] * 4 + [_i64] * 4 + [_i32] * 5 + [_ptr] * 5
MAX_SHARDS = 16  # shards of one device in one launch: csrc k1::MAX_SHARDS
counters = LaunchCounters()  # the float32 form (unsharded, or a device's shards)
bf16_counters = LaunchCounters()  # the bf16 form
positive_counters = LaunchCounters()  # k1_positive_shards, both forms
merge_counters = LaunchCounters()  # k1_merge_runs, the cross-shard merge
_PLANS = Plans()  # the shards' checks and pointer arrays, by signature


@functools.lru_cache(maxsize=None)
def first_pass(nq: int, k: int, bf16: bool, device_index: int):
    """(queries per block, gallery rows per tile, blocks per SM) of K1's
    first pass for ``nq`` queries and a top-``k`` in the float32 or bf16
    form on the card ``device_index``, as the kernel reports them."""
    return KERNEL.ask("k1_first_pass", (nq, k, int(bf16)), 3, device_index)


def form_counters(dtype: torch.dtype) -> LaunchCounters:
    """The launch counters of the form that takes operands of ``dtype``."""
    return bf16_counters if dtype == torch.bfloat16 else counters


# ------------------------------------------------------------- the sweep

def _distances(q, qq, g, gg, metric):
    """(Q, N) distances of the plain version, in the sweep's formula."""
    cross = _cross(q, g, "default" if g.dtype == torch.bfloat16
                   else "highest")
    if metric == "euclidean":
        return torch.clamp(qq + gg - 2.0 * cross, min=0.0)
    return 1.0 - cross / torch.clamp(qq * gg, min=COSINE_EPS)


def fused_sweep_reference(q, qq, pos, g, gg, *, k: int, metric: str,
                          with_ranks: bool, d2pos=None):
    """Plain PyTorch version of the sweep (the CPU route, and the card's
    yardstick for the kernel). Inputs as :func:`fused_sweep_cuda`;
    ``d2pos`` (Q,): the positive's distance given (a shard of a row-sharded
    gallery, whose ``pos`` is then the positive's local column, -1 before
    the shard and N after it). Returns (ranks (Q,), vals (Q, k), idx (Q,
    k), exact (Q,))."""
    d = _distances(q, qq, g, gg, metric)
    nq, n = d.shape
    if with_ranks:
        col = torch.arange(n, device=d.device)[None, :]
        if d2pos is None:
            d2pos = torch.gather(d, 1, torch.clamp(pos.long(), 0, n - 1))
        else:
            d2pos = d2pos.reshape(nq, 1)
        hit = (d < d2pos) | ((d == d2pos) & (col < pos))
        hit = hit & (d < BIG) & (col != pos)
        ranks = torch.sum(hit, dim=1).to(torch.int32)
    else:
        ranks = torch.zeros(nq, dtype=torch.int32, device=d.device)
    vals, order = torch.sort(d, dim=1, stable=True)
    vals, idx = vals[:, :k], order[:, :k].to(torch.int32)
    keep = vals < BIG  # a column at or past the sentinel never enters
    vals = torch.where(keep, vals, BIG)
    idx = torch.where(keep, idx, n)
    return ranks, vals, idx, torch.ones(nq, dtype=torch.int32, device=d.device)


def _check_like(dev, *specs):
    """Each (name, tensor, dtype, shape) of ``specs``: contiguous, of that
    type and shape, on ``dev``."""
    for name, t, dtype, shape in specs:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"K1 input {name}: want contiguous {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_rows(op, d, *rows):
    """16-byte rows of ``op``: D a multiple of a load, ``rows`` aligned."""
    if op not in _VEC:
        raise ValueError(f"K1 takes float32 or bf16 operands, got {op}")
    vec = _VEC[op]
    if d % vec or any(t.data_ptr() % 16 for t in rows):
        raise ValueError(f"K1 reads 16-byte rows of {op}: D={d} must be a "
                         f"multiple of {vec} and q, g 16-byte aligned")


def _check_queries(q, qq, pos, op, d, dev):
    nq = q.shape[0]
    _check_like(dev, ("q", q, op, (nq, d)),
                ("qq", qq, torch.float32, (nq, 1)),
                ("pos", pos, torch.int32, (nq, 1)))


def _check_inputs(q, qq, pos, g, gg):
    """K1's input contract (see :func:`fused_sweep_cuda`)."""
    dev, op = g.device, g.dtype
    n, d = g.shape[0], q.shape[1]
    _check_rows(op, d, q, g)
    _check_queries(q, qq, pos, op, d, dev)
    _check_like(dev, ("g", g, op, (n, d)), ("gg", gg, torch.float32, (1, n)))


def fused_sweep_cuda(q, qq, pos, g, gg, *, k: int, metric: str,
                     with_ranks: bool):
    """Launch K1 on the card. ``q`` (Q, D) and ``g`` (N, D) both float32
    (the ``'highest'`` form) or both bf16 (the ``'default'`` form), ``qq``
    (Q, 1) float32, ``pos`` (Q, 1) int32, ``gg`` (1, N) float32; all
    contiguous on one CUDA device, q and g 16-byte aligned, D a multiple
    of 4 (float32) or 8 (bf16). K1 computes the positive's distance from
    ``pos`` before its sweep."""
    _check_inputs(q, qq, pos, g, gg)
    dev = g.device
    nq, d = q.shape
    n = g.shape[0]
    op, f32, i32 = g.dtype, torch.float32, torch.int32
    if not 1 <= k <= K_MAX:
        raise ValueError(f"K1 takes 1 <= k <= {K_MAX}, got {k}")
    ranks = torch.empty(nq, dtype=i32, device=dev)
    vals = torch.empty((nq, k), dtype=f32, device=dev)
    idx = torch.empty((nq, k), dtype=i32, device=dev)
    exact = torch.empty(nq, dtype=i32, device=dev)
    if nq == 0:
        return ranks, vals, idx, exact
    tq, tn, per_sm = first_pass(nq, k, op == torch.bfloat16, dev.index)
    s = grid_splits(-(-nq // tq), -(-n // tn), dev, per_sm=per_sm)
    d2pos = torch.empty(nq, dtype=f32, device=dev)
    part_v = torch.empty((nq, s, k), dtype=f32, device=dev)
    part_i = torch.empty((nq, s, k), dtype=i32, device=dev)
    part_r = torch.empty((nq, s), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(q.data_ptr(), qq.data_ptr(), pos.data_ptr(),
                      g.data_ptr(), gg.data_ptr(), nq, n, d, k,
                      _METRICS[metric], int(with_ranks),
                      int(op == torch.bfloat16), s, d2pos.data_ptr(),
                      part_v.data_ptr(), part_i.data_ptr(), part_r.data_ptr(),
                      ranks.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                      exact.data_ptr(), stream)
    form_counters(op).add(launches=1)
    return ranks, vals, idx, exact


def fused_sweep(q, qq, pos, g, gg, *, k: int, metric: str,
                with_ranks: bool):
    """The plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    if g.device.type == "cpu":
        return fused_sweep_reference(q, qq, pos, g, gg, k=k, metric=metric,
                                     with_ranks=with_ranks)
    if g.device.type == "cuda":
        return fused_sweep_cuda(q, qq, pos, g, gg, k=k, metric=metric,
                                with_ranks=with_ranks)
    raise ValueError(f"K1 has no route for device {g.device}")


# ------------------------------------- the shards of one device, the merge

def _host_array(ctype, values):
    return (ctype * len(values))(*values)


def positive_distance_shards_reference(q, qq, pos, shards, norms, row0,
                                       n: int, *, metric: str):
    """Plain version of :func:`positive_distance_shards_cuda`: each query's
    distance to its positive (the global row ``pos`` clamped into
    ``[0, n)``) from the plain sweep's distances over the shard that holds
    it, and 0 where none of ``shards`` does."""
    nl = shards[0].shape[0]
    p = torch.clamp(pos.reshape(-1).long(), 0, n - 1)
    out = torch.zeros(p.shape[0], dtype=torch.float32, device=q.device)
    for g, gg, first in zip(shards, norms, row0):
        own = (p >= first) & (p < first + nl)
        d = torch.gather(_distances(q, qq, g, gg, metric), 1,
                         torch.clamp(p - first, 0, nl - 1)[:, None])[:, 0]
        out = torch.where(own, d, out)
    return out


def _shard_plan(q, qq, pos, shards, norms, row0, n):
    """The shards' contract (see :func:`sweep_shards_cuda`), checked once
    a signature of the shards, and the queries' each call: (C, N / C, the
    host arrays of the shards' and norms' pointers and first rows)."""

    def make():
        c, nl = len(shards), shards[0].shape[0]
        if not 1 <= c <= MAX_SHARDS:
            raise ValueError(f"K1 takes 1 to {MAX_SHARDS} shards a launch, "
                             f"got {c}")
        if len(norms) != c or len(row0) != c or any(
                not 0 <= r <= n - nl for r in row0):
            raise ValueError(f"K1 shards: {c} shards of {nl} rows want {c} "
                             f"norms and first rows in [0, {n - nl}]")
        g0 = shards[0]
        _check_rows(g0.dtype, g0.shape[1], *shards)
        for g, gg in zip(shards, norms):
            _check_like(g0.device, ("g", g, g0.dtype, tuple(g0.shape)),
                        ("gg", gg, torch.float32, (1, nl)))
        return (c, nl, _host_array(_ptr, [g.data_ptr() for g in shards]),
                _host_array(_ptr, [gg.data_ptr() for gg in norms]),
                _host_array(_i32, row0))

    plan = _PLANS.get((tuple(row0), n) + signature((*shards, *norms)), make)
    g0 = shards[0]
    _check_rows(g0.dtype, g0.shape[1], q)
    _check_queries(q, qq, pos, g0.dtype, g0.shape[1], g0.device)
    return plan


def positive_distance_shards_cuda(q, qq, pos, shards, norms, row0, n: int,
                                  *, metric: str):
    """Launch K1's positive-distance kernel once over the shards of one
    card (the same arithmetic as the sweep's column of the positive):
    (Q,) float32, each query's distance to its positive, the global row
    ``pos`` clamped into ``[0, n)``, where one of ``shards`` holds it, and
    0 where none does. Inputs as :func:`sweep_shards_cuda`'s."""
    c, nl, g_arr, gg_arr, row0_arr = _shard_plan(q, qq, pos, shards, norms,
                                                 row0, n)
    nq, d = q.shape
    out = torch.empty(nq, dtype=torch.float32, device=q.device)
    if nq == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        KERNEL.call("k1_positive_shards", POSITIVE_ARGTYPES, q.data_ptr(),
                    qq.data_ptr(), pos.data_ptr(), g_arr, gg_arr, row0_arr,
                    c, n, nq, nl, d,
                    _METRICS[metric], int(q.dtype == torch.bfloat16),
                    out.data_ptr(), stream)
    positive_counters.add(launches=1)
    return out


def positive_distance_shards(q, qq, pos, shards, norms, row0, n: int, *,
                             metric: str):
    """The plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    if q.device.type == "cpu":
        return positive_distance_shards_reference(
            q, qq, pos, shards, norms, row0, n, metric=metric)
    if q.device.type == "cuda":
        return positive_distance_shards_cuda(q, qq, pos, shards, norms, row0,
                                             n, metric=metric)
    raise ValueError(f"K1 has no route for device {q.device}")


def sweep_shards_reference(q, qq, pos, shards, norms, row0, n: int, *,
                           k: int, metric: str, with_ranks: bool,
                           d2pos=None, out=None):
    """Plain version of :func:`sweep_shards_cuda`: the plain sweep of each
    shard with the positive's local column (clamped to ``[-1, N / C]``:
    -1 counts the strictly closer columns only, N / C the ties too, so
    the rank partials sum to the global rank), global indices (an unfilled
    slot at ``n``), merged by :func:`~art_sbir_tpu_torch.ops.sharded.
    merge_shard_runs_reference`."""
    nl = shards[0].shape[0]
    outs = []
    for g, gg, first in zip(shards, norms, row0):
        p = torch.clamp(pos - first, -1, nl) if with_ranks else pos
        r, v, i, e = fused_sweep_reference(q, qq, p, g, gg, k=k,
                                           metric=metric,
                                           with_ranks=with_ranks,
                                           d2pos=d2pos)
        outs.append((r, v, torch.where(i >= nl, n, i + first), e))
    ranks, vals, idx, exact = (torch.stack([o[j] for o in outs])
                               for j in range(4))
    return merge_shard_runs_reference(vals, idx, k, n, ranks=ranks,
                                      exact=exact, out=out)


def _outputs(out, nq: int, k: int, dev, with_ranks: bool = True):
    """(ranks, vals, idx, exact) to write into: ``out`` checked, or new
    (no ranks without ``with_ranks``)."""
    f32, i32 = torch.float32, torch.int32
    want = ((i32, (nq,)), (f32, (nq, k)), (i32, (nq, k)), (i32, (nq,)))
    if out is None:
        return tuple(torch.empty(shape, dtype=dtype, device=dev)
                     if with_ranks or j else None
                     for j, (dtype, shape) in enumerate(want))
    for t, (dtype, shape) in zip(out, want):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"K1 output: want contiguous {dtype} {shape} "
                             f"on {dev}")
    return out


def sweep_shards_cuda(q, qq, pos, shards, norms, row0, n: int, *, k: int,
                      metric: str, with_ranks: bool, d2pos=None, out=None):
    """Launch K1 once over the C shards of one card: ``shards`` C (N / C,
    D) tensors of the operand type of ``q`` (as :func:`fused_sweep_cuda`'s
    ``g``), ``norms`` their (1, N / C) norms, ``row0`` their first global
    rows, ``n`` the rows of the whole gallery; ``pos`` (Q, 1) int32 the
    positives' global rows and ``d2pos`` (Q,) float32 their distances
    (:func:`positive_distance_shards`, summed over the cards), needed
    with ranks. One sweep over every shard (C times the splits of one) and
    one merge of all their runs by (value, global index): (ranks, vals,
    idx, exact) over these shards, global indices, an unfilled slot at
    ``n``, written into ``out`` where given (as :func:`_outputs`)."""
    c, nl, g_arr, gg_arr, row0_arr = _shard_plan(q, qq, pos, shards, norms,
                                                 row0, n)
    dev = q.device
    nq, d = q.shape
    op, f32, i32 = q.dtype, torch.float32, torch.int32
    if not 1 <= k <= min(K_MAX, nl):
        raise ValueError(f"K1 takes 1 <= k <= min({K_MAX}, {nl}), got {k}")
    if with_ranks and (d2pos is None or d2pos.device != dev
                       or d2pos.dtype != f32 or tuple(d2pos.shape) != (nq,)):
        raise ValueError("K1 over shards with ranks wants d2pos (Q,) "
                         f"float32 on {dev}")
    ranks, vals, idx, exact = _outputs(out, nq, k, dev)
    if nq == 0:
        return ranks, vals, idx, exact
    tq, tn, per_sm = first_pass(nq, k, op == torch.bfloat16, dev.index)
    n_tiles = -(-nl // tn)
    total = grid_splits(-(-nq // tq), c * n_tiles, dev, per_sm=per_sm)
    s = max(1, min(n_tiles, total // c))
    runs = c * s
    # part_v, part_i (Q, runs, k) and part_r (Q, runs): one scratch buffer
    buf = scratch(dev, 4 * nq * runs * (2 * k + 1))
    base, step = buf.data_ptr(), 4 * nq * runs * k
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.call("k1_sweep_shards", SWEEP_ARGTYPES, q.data_ptr(),
                    qq.data_ptr(), pos.data_ptr(), g_arr, gg_arr, row0_arr,
                    c, n, nq, nl, d, k,
                    _METRICS[metric], int(with_ranks),
                    int(op == torch.bfloat16), s,
                    d2pos.data_ptr() if with_ranks else None,
                    base, base + step, base + 2 * step, ranks.data_ptr(),
                    vals.data_ptr(), idx.data_ptr(), exact.data_ptr(), stream)
    form_counters(op).add(launches=1)
    return ranks, vals, idx, exact


def sweep_shards(q, qq, pos, shards, norms, row0, n: int, *, k: int,
                 metric: str, with_ranks: bool, d2pos=None, out=None):
    """The plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    kw = dict(k=k, metric=metric, with_ranks=with_ranks, d2pos=d2pos,
              out=out)
    if q.device.type == "cpu":
        return sweep_shards_reference(q, qq, pos, shards, norms, row0, n,
                                      **kw)
    if q.device.type == "cuda":
        return sweep_shards_cuda(q, qq, pos, shards, norms, row0, n, **kw)
    raise ValueError(f"K1 has no route for device {q.device}")


def merge_shard_runs_cuda(vals, idx, k: int, n: int, ranks=None,
                          exact=None, out=None):
    """Launch K1's cross-shard merge (``k1_merge_runs``): ``vals`` float32
    and ``idx`` int32 (S, Q, L) of one stride layout, the last dimension
    contiguous, each run ascending by (value, global index); ``ranks`` and
    ``exact`` (S, Q) int32 of one stride layout, or None; all on one card,
    S <= 1,024, k <= S * L; ``n`` the sentinel index. Returns (ranks (Q,)
    int32 or None, vals (Q, k), idx (Q, k) int32, exact (Q,) int32): the
    k smallest by (value, index), the rank partials summed, the
    certificates ANDed; written into ``out`` where given (as
    :func:`_outputs`; its ranks are left as they are without ``ranks``)."""
    dev = vals.device
    n_runs, nq, length = vals.shape
    side = [t for t in (ranks, exact) if t is not None]
    if (vals.dtype != torch.float32 or idx.dtype != torch.int32
            or idx.shape != vals.shape or idx.stride() != vals.stride()
            or vals.stride(2) != 1 or idx.device != dev
            or any(t.dtype != torch.int32 or t.device != dev
                   or tuple(t.shape) != (n_runs, nq)
                   or t.stride() != side[0].stride() for t in side)):
        raise ValueError("the cross-shard merge wants float32 and int32 "
                         "(S, Q, L) runs of one layout and int32 (S, Q) "
                         f"ranks and certificates on {dev}")
    if not (1 <= n_runs <= 1024 and 1 <= k <= n_runs * length):
        raise ValueError(f"the cross-shard merge takes 1 to 1024 runs and "
                         f"k <= S * L, got S={n_runs}, L={length}, k={k}")
    out_r, out_v, out_i, out_e = _outputs(out, nq, k, dev,
                                          with_ranks=ranks is not None)
    if ranks is None:
        out_r = None
    if nq == 0:
        return out_r, out_v, out_i, out_e
    rs, rq = side[0].stride() if side else (0, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.call("k1_merge_runs", MERGE_ARGTYPES, vals.data_ptr(),
                    idx.data_ptr(),
                    None if ranks is None else ranks.data_ptr(),
                    None if exact is None else exact.data_ptr(),
                    vals.stride(1), vals.stride(0), rq, rs, n_runs, length,
                    nq, k, n, None if out_r is None else out_r.data_ptr(),
                    out_v.data_ptr(), out_i.data_ptr(), out_e.data_ptr(),
                    stream)
    merge_counters.add(launches=1)
    return out_r, out_v, out_i, out_e


def merge_shard_runs(vals, idx, k: int, n: int, ranks=None, exact=None,
                     out=None):
    """The cross-shard merge: the plain version
    (:func:`~art_sbir_tpu_torch.ops.sharded.merge_shard_runs_reference`)
    for CPU tensors, K1's merge kernel for CUDA ones."""
    kw = dict(ranks=ranks, exact=exact, out=out)
    if vals.device.type == "cpu":
        return merge_shard_runs_reference(vals, idx, k, n, **kw)
    if vals.device.type == "cuda":
        return merge_shard_runs_cuda(vals, idx, k, n, **kw)
    raise ValueError(f"the merge has no route for device {vals.device}")


def sum_order_bound(q, g, idx, qq, gg, metric: str) -> torch.Tensor:
    """(Q, k) bound on how far two sums of the bf16 form's cross term in
    different orders can move the distances of the columns ``idx``.

    The products of bf16 operands are exact in float32, so two routes
    differ only in the order (and, on the tensor cores, the rounding) of
    the float32 sum. Allowing each addition a relative error of 2^-23 (a
    truncating accumulator), each route's cross term lies within
    ``g_D = D * 2^-23`` times ``A = sum_d |q_d g_d|`` of the exact one, so
    the two lie within ``2 g_D A`` of each other. The euclidean distance
    ``qq + gg - 2 cross`` doubles that; its final subtraction rounds by at
    most 2^-23 of its terms in each route. The cosine distance ``1 - cross
    / den`` divides it by ``den``; its division and subtraction round by at
    most 2^-23 of ``1 + |cross| / den`` in each. ``q`` (Q, D), ``g``
    (N, D) bf16; ``idx`` (Q, k); ``qq`` (Q, 1), ``gg`` (1, N) float32."""
    cols = idx.long().clamp(0, g.shape[0] - 1)
    qf, rows = q.float()[:, None, :], g[cols].float()
    a = torch.sum(torch.abs(qf * rows), dim=2)
    cross = torch.sum(qf * rows, dim=2)
    g_d = q.shape[1] * 2.0 ** -23
    gsel = torch.gather(gg.expand(q.shape[0], -1), 1, cols)
    if metric == "euclidean":
        return (4.0 * g_d * a
                + 2.0 ** -22 * (qq.abs() + gsel.abs() + 2.0 * cross.abs()))
    den = torch.clamp(qq * gsel, min=COSINE_EPS)
    return 2.0 * g_d * a / den + 2.0 ** -22 * (1.0 + cross.abs() / den)


def _check_metric(metric: str) -> None:
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r} (euclidean|cosine)")


def query_norms(queries, metric):
    """(Q, 1) query norms in the op order of the TPU kernel's
    ``_prep_norms``: the eps-folded squared norm ``|q|^2 + 2 eps sum q +
    D eps^2`` for euclidean, the plain L2 norm for cosine. (Its third
    output, the positive's distance, comes from each route's own
    arithmetic here: see the module docstring.)"""
    _check_metric(metric)
    q32 = queries.float()
    if metric == "cosine":
        return torch.linalg.vector_norm(q32, dim=1, keepdim=True)
    eps = PAIRWISE_EPS
    return (torch.sum(q32 * q32, dim=1, keepdim=True)
            + 2.0 * eps * torch.sum(q32, dim=1, keepdim=True)
            + queries.shape[1] * eps * eps)


def gallery_norms(gallery, metric):
    """(1, N) gallery norms in the TPU kernel's op order: ``|g|^2 - 2 eps
    sum g`` for euclidean (so ``||q - g + eps||^2 = qq' + gg' - 2 q.g``),
    the plain L2 norm for cosine. An engine over an immutable gallery
    computes them once and passes them to every search."""
    _check_metric(metric)
    g32 = gallery.float()
    if metric == "cosine":
        return torch.linalg.vector_norm(g32, dim=1)[None, :]
    return (torch.sum(g32 * g32, dim=1)
            - 2.0 * PAIRWISE_EPS * torch.sum(g32, dim=1))[None, :]


def _check_precision(precision: str) -> None:
    if precision not in _OPERANDS:
        raise ValueError(
            f"unknown precision {precision!r} (highest|default)")


def retrieve_fused_core(queries: torch.Tensor, gallery: torch.Tensor,
                        pos_idx: torch.Tensor, k: int = 10,
                        precision: str = "highest",
                        metric: str = "euclidean", with_ranks: bool = True,
                        gg: torch.Tensor | None = None
                        ) -> Tuple[torch.Tensor, ...]:
    """One sweep: (ranks, topk_sq_values, topk_indices, exact).
    ``with_ranks=False`` skips the rank count and returns zero ranks (the
    serving path ranks nothing). ``gg``: the gallery's
    :func:`gallery_norms` for ``metric``, computed here when absent.
    ``precision='default'`` streams bf16 operands (see the module note)."""
    _check_precision(precision)
    if k > gallery.shape[0]:
        raise ValueError(
            f"k={k} exceeds gallery size {gallery.shape[0]}: unfilled top-k "
            "slots would hold the sentinel. Clamp k to min(k, len(gallery)).")
    if k > K_MAX:
        raise ValueError(f"k must be <= {K_MAX}, got {k}")
    with torch.no_grad():
        qq = query_norms(queries, metric)
        if gg is None:
            gg = gallery_norms(gallery, metric)
        pos2d = pos_idx.to(torch.int32).reshape(-1, 1).contiguous()
        op = _OPERANDS[precision]
        return fused_sweep(queries.to(op).contiguous(), qq, pos2d,
                           gallery.to(op).contiguous(), gg, k=k,
                           metric=metric, with_ranks=with_ranks)


def retrieve_fused(queries: torch.Tensor, gallery: torch.Tensor,
                   pos_idx: torch.Tensor, k: int = 10,
                   precision: str = "highest", metric: str = "euclidean",
                   with_ranks: bool = True, device_get: bool = False,
                   gg: torch.Tensor | None = None):
    """(ranks, topk_values, topk_indices) over the gallery.

    ``metric='euclidean'`` reports *squared* eps-folded distances (take
    sqrt for the exact route's values); ``'cosine'`` reports
    ``1 - cos_sim``. ``precision``: ``'highest'`` (float32 operands) or
    ``'default'`` (bf16 operands; pass a bf16 gallery to skip the per-call
    cast). Rows whose certificate failed are recomputed with
    :func:`retrieve_chunked` at the same precision and counted in the
    form's ``fallback_rows`` (``counters`` or ``bf16_counters``).
    ``device_get=True`` returns numpy arrays. ``gg`` as in
    :func:`retrieve_fused_core`.
    """
    return _certified(
        retrieve_fused_core(queries, gallery, pos_idx, k=k,
                            precision=precision, metric=metric,
                            with_ranks=with_ranks, gg=gg),
        queries, lambda: gallery, pos_idx, k=k, precision=precision,
        metric=metric, with_ranks=with_ranks, device_get=device_get)


def _certified(swept, queries, whole_gallery, pos_idx, *, k, precision,
               metric, with_ranks, device_get):
    """(ranks, vals, idx) from a sweep's (ranks, vals, idx, exact): rows
    whose certificate failed are recomputed with :func:`retrieve_chunked`
    over ``whole_gallery()`` and counted in the form's ``fallback_rows``."""
    ranks, vals, idx, exact = swept
    if device_get:
        ranks, vals, idx, exact_h = (t.cpu().numpy()
                                     for t in (ranks, vals, idx, exact))
    else:
        exact_h = exact.cpu().numpy()
    if exact_h.all():
        return ranks, vals, idx
    bad = np.nonzero(exact_h == 0)[0]
    form_counters(_OPERANDS[precision]).add(fallback_rows=len(bad))
    bad_t = torch.as_tensor(bad, device=queries.device)
    with torch.no_grad():
        rb, vb, ib = retrieve_chunked(
            queries[bad_t], whole_gallery(), pos_idx[bad_t], k=k,
            precision=precision, metric=metric,
            chunk=min(256, max(1, len(bad))))
    if metric == "euclidean":  # the exact route reports sqrt'd distances
        vb = torch.square(vb)
    if device_get:
        if with_ranks:  # else keep the kernel's zero ranks
            ranks[bad] = rb.cpu().numpy()
        vals[bad] = vb.cpu().numpy()
        idx[bad] = ib.cpu().numpy()
        return ranks, vals, idx
    if with_ranks:
        ranks[bad_t] = rb.to(ranks.dtype)
    vals[bad_t] = vb
    idx[bad_t] = ib.to(idx.dtype)
    return ranks, vals, idx


# ------------------------------------------------ the row-sharded gallery

def _shard_sizes(gallery, mesh) -> Tuple[int, int]:
    """(N, rows a shard) of a gallery given whole or as one shard a mesh
    device."""
    if isinstance(gallery, torch.Tensor):
        n = int(gallery.shape[0])
    else:
        n = sum(int(g.shape[0]) for g in gallery)
    return n, n // max(mesh.size, 1)


def shard_gallery(gallery, mesh, gg=None, metric: str = "euclidean"):
    """(gallery shards, norm shards): shard ``i`` on ``mesh.devices[i]``.

    ``gallery``: the (N, D) tensor, cut into contiguous ``N / S`` rows, or
    a sequence of S (N / S, D) shards already placed. ``gg``: the (1, N)
    :func:`gallery_norms`, a sequence of S (1, N / S) ones, or None. Absent
    norms are computed from the whole tensor where the gallery is given
    whole (so that they are the unsharded sweep's), else on each shard's
    device."""
    n, nl = _shard_sizes(gallery, mesh)
    if isinstance(gallery, torch.Tensor):
        if n % mesh.size:
            raise ValueError(
                f"gallery rows ({n}) must be divisible by the "
                f"'{mesh.axis_name}' mesh axis ({mesh.size}); pad the "
                "gallery (see parallel.mesh.pad_to_multiple)")
        if gg is None:
            gg = gallery_norms(gallery, metric)
        shards = shard_rows(gallery, mesh)
    else:
        shards = list(gallery)
        if (len(shards) != mesh.size
                or any(g.shape[0] != nl for g in shards)):
            raise ValueError(
                f"want {mesh.size} gallery shards of {nl} rows, got "
                f"{[int(g.shape[0]) for g in shards]}")
    if gg is None:
        gg = [gallery_norms(g, metric) for g in shards]
    elif isinstance(gg, torch.Tensor):
        gg = [gg[:, i * nl:(i + 1) * nl].to(d)
              for i, d in enumerate(mesh.devices)]
    return shards, list(gg)


def retrieve_fused_sharded_core(queries: torch.Tensor, gallery, pos_idx,
                                mesh, k: int = 10,
                                precision: str = "highest",
                                metric: str = "euclidean",
                                with_ranks: bool = True, gg=None,
                                reference: bool = False
                                ) -> Tuple[torch.Tensor, ...]:
    """K1 over a row-sharded gallery: (ranks, vals, idx, exact) on
    ``mesh.devices[0]``, as :func:`retrieve_fused_core` gives them over
    the whole gallery. ``gallery`` and ``gg`` as :func:`shard_gallery`
    takes them. ``reference=True`` runs the plain versions of the
    kernels on whatever device (the card's yardstick for the kernels).

    The queries' norms are computed once and sent once to each device.
    The shards that share a device are one launch of each kernel
    (:func:`sweep_shards`): the positive's distance is computed by the
    shard that holds the positive, with that shard's norms
    (:func:`positive_distance_shards`: one launch a device, 0 for the
    positives held elsewhere, the devices' vectors summed where there are
    several), and given to every shard, so that a copy of the positive in
    another shard ties with it exactly; then one sweep over the device's
    shards and one merge of their runs by (value, global index), the rank
    partials summed. Over several devices their results merge on the
    first (:func:`merge_shard_runs`: one launch), the certificates
    ANDed. Over several devices each device's inputs go to it in one
    copy (:func:`~art_sbir_tpu_torch.ops.sharded.pack`), and each
    device's result comes back in one (a record,
    :func:`~art_sbir_tpu_torch.ops.sharded.record_views`)."""
    _check_precision(precision)
    _check_metric(metric)
    n, nl = _shard_sizes(gallery, mesh)
    # each shard's top-k holds only its own rows: k is bounded by them
    if k > nl:
        raise ValueError(
            f"k={k} exceeds the per-shard gallery size {nl} "
            f"({n} rows over {mesh.size} devices): unfilled per-shard "
            "top-k slots would hold the sentinel and fail every row's "
            "exactness certificate. Clamp k to the shard size "
            "(evaluate_retrieval clamps to the global size; shrink the "
            "mesh axis or pad the gallery for larger k).")
    if k > K_MAX:
        raise ValueError(f"k must be <= {K_MAX}, got {k}")
    shards, gg_shards = shard_gallery(gallery, mesh, gg, metric)
    dev0, op = mesh.devices[0], _OPERANDS[precision]
    positive, sweep, merge = (
        (positive_distance_shards_reference, sweep_shards_reference,
         merge_shard_runs_reference) if reference
        else (positive_distance_shards, sweep_shards, merge_shard_runs))
    with torch.no_grad():
        q0 = queries.to(dev0)
        qq = query_norms(q0, metric)
        q_op = q0.to(op).contiguous()
        pos = pos_idx.to(dev0, torch.int32).reshape(-1, 1).contiguous()
        groups = device_groups(mesh)
        inputs = [q_op, qq, pos]
        if len(groups) > 1:
            # Each device's inputs reach it before any kernel is queued, in
            # one copy: a copy between cards runs on the source card's
            # stream, behind whatever that card was given before it, so a
            # copy queued after the first card's sweep would hold every
            # other card back.
            blob = pack(inputs)
            sent = [unpack(blob.to(d), inputs) for d, _ in groups]
        else:
            sent = [inputs]
        on = [(d, *s, [shards[i].to(op).contiguous() for i in members],
               [gg_shards[i] for i in members], [i * nl for i in members])
              for (d, members), s in zip(groups, sent)]
        d2pos = [None] * len(on)
        if with_ranks:  # from the shard that holds each (clamped) positive
            d2pos = [positive(q, qq_d, p, gs, ns, r0, n, metric=metric)
                     for _, q, qq_d, p, gs, ns, r0 in on]
            if len(on) > 1:  # one device holds each, the others gave 0
                total = gather_to(d2pos, dev0).sum(0)
                d2pos = [total.to(d) for d, *_ in on]
        kw = dict(k=k, metric=metric, with_ranks=with_ranks)
        if len(on) == 1:
            _, q, qq_d, p, gs, ns, r0 = on[0]
            return sweep(q, qq_d, p, gs, ns, r0, n, d2pos=d2pos[0], **kw)
        # each device's result into its record, the first's in place
        nq, words = q_op.shape[0], record_words(q_op.shape[0], k)
        records = torch.empty((len(on), words), dtype=torch.int32,
                              device=dev0)
        local = [records[0]] + [torch.empty(words, dtype=torch.int32,
                                            device=d) for d, *_ in on[1:]]
        for (_, q, qq_d, p, gs, ns, r0), dp, rec in zip(on, d2pos, local):
            sweep(q, qq_d, p, gs, ns, r0, n, d2pos=dp,
                  out=record_views(rec, nq, k), **kw)
        for j in range(1, len(on)):
            records[j].copy_(local[j])
        ranks, vals, idx, exact = record_views(records, nq, k)
        return merge(vals, idx, k, n, ranks=ranks, exact=exact)


def retrieve_fused_sharded(queries: torch.Tensor, gallery, pos_idx, mesh,
                           k: int = 10, precision: str = "highest",
                           metric: str = "euclidean", with_ranks: bool = True,
                           device_get: bool = False, gg=None):
    """(ranks, topk_values, topk_indices) over a row-sharded gallery
    (:func:`retrieve_fused_sharded_core`), with :func:`retrieve_fused`'s
    value contract and certificate fallback (the flagged rows recomputed
    over the whole gallery, brought to ``mesh.devices[0]``)."""
    dev0 = mesh.devices[0]
    queries, pos_idx = queries.to(dev0), pos_idx.to(dev0)

    def whole():
        if isinstance(gallery, torch.Tensor):
            return gallery.to(dev0)
        return torch.cat([g.to(dev0) for g in gallery])

    return _certified(
        retrieve_fused_sharded_core(queries, gallery, pos_idx, mesh, k=k,
                                    precision=precision, metric=metric,
                                    with_ranks=with_ranks, gg=gg),
        queries, whole, pos_idx, k=k, precision=precision, metric=metric,
        with_ranks=with_ranks, device_get=device_get)
