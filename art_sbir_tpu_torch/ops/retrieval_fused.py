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
                                                grid_splits)
from art_sbir_tpu_torch.ops.distance import (COSINE_EPS, PAIRWISE_EPS,
                                             _cross, retrieve_chunked)
from art_sbir_tpu_torch.ops.sharded import gather_to, lexsort_topk_merge
from art_sbir_tpu_torch.parallel.mesh import shard_rows

BIG = 3.0e38  # sentinel value: worse than any distance
K_MAX = 128
_METRICS = {"euclidean": 0, "cosine": 1}

_OPERANDS = {"highest": torch.float32, "default": torch.bfloat16}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte load

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("fused_retrieval", "k1_fused_retrieval",
                    [_ptr] * 5 + [_i32] * 9 + [_ptr] * 8 + [_ptr], label="K1")
# the standalone launch of K1's positive-distance kernels (sharded K1)
POSITIVE_ARGTYPES = [_ptr] * 5 + [_i32] * 5 + [_ptr] * 2
counters = LaunchCounters()  # the float32 form
bf16_counters = LaunchCounters()  # the bf16 form
positive_counters = LaunchCounters()  # k1_positive_distance, both forms


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
    returns (ranks (Q,), vals (Q, k), idx (Q, k), exact (Q,))."""
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


def _check_inputs(q, qq, pos, g, gg, d2pos=None):
    """K1's input contract (see :func:`fused_sweep_cuda`)."""
    dev = g.device
    nq, d = q.shape
    n = g.shape[0]
    op, f32, i32 = g.dtype, torch.float32, torch.int32
    if op not in _VEC:
        raise ValueError(f"K1 takes float32 or bf16 operands, got {op}")
    given = () if d2pos is None else (("d2pos", d2pos, f32, (nq,)),)
    for name, t, dtype, shape in (
            ("q", q, op, (nq, d)), ("qq", qq, f32, (nq, 1)),
            ("pos", pos, i32, (nq, 1)),
            ("g", g, op, (n, d)), ("gg", gg, f32, (1, n))) + given:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"K1 input {name}: want contiguous {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    vec = _VEC[op]
    if d % vec or q.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError(f"K1 reads 16-byte rows of {op}: D={d} must be a "
                         f"multiple of {vec} and q, g 16-byte aligned")


def fused_sweep_cuda(q, qq, pos, g, gg, *, k: int, metric: str,
                     with_ranks: bool, d2pos=None):
    """Launch K1 on the card. ``q`` (Q, D) and ``g`` (N, D) both float32
    (the ``'highest'`` form) or both bf16 (the ``'default'`` form), ``qq``
    (Q, 1) float32, ``pos`` (Q, 1) int32, ``gg`` (1, N) float32; all
    contiguous on one CUDA device, q and g 16-byte aligned, D a multiple
    of 4 (float32) or 8 (bf16). ``d2pos`` (Q,) float32: the positive's
    distance given (a shard of a row-sharded gallery, whose ``pos`` is
    then the positive's local column, -1 before the shard, N after it),
    else K1 computes it from ``pos`` before its sweep."""
    _check_inputs(q, qq, pos, g, gg, d2pos)
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
    given = d2pos is not None
    if not given:
        d2pos = torch.empty(nq, dtype=f32, device=dev)
    part_v = torch.empty((nq, s, k), dtype=f32, device=dev)
    part_i = torch.empty((nq, s, k), dtype=i32, device=dev)
    part_r = torch.empty((nq, s), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(q.data_ptr(), qq.data_ptr(), pos.data_ptr(),
                      g.data_ptr(), gg.data_ptr(), nq, n, d, k,
                      _METRICS[metric], int(with_ranks),
                      int(op == torch.bfloat16), s, int(given),
                      d2pos.data_ptr(),
                      part_v.data_ptr(), part_i.data_ptr(), part_r.data_ptr(),
                      ranks.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                      exact.data_ptr(), stream)
    form_counters(op).add(launches=1)
    return ranks, vals, idx, exact


def fused_sweep(q, qq, pos, g, gg, *, k: int, metric: str,
                with_ranks: bool, d2pos=None):
    """The plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    if g.device.type == "cpu":
        return fused_sweep_reference(q, qq, pos, g, gg, k=k, metric=metric,
                                     with_ranks=with_ranks, d2pos=d2pos)
    if g.device.type == "cuda":
        return fused_sweep_cuda(q, qq, pos, g, gg, k=k, metric=metric,
                                with_ranks=with_ranks, d2pos=d2pos)
    raise ValueError(f"K1 has no route for device {g.device}")


# ----------------------------------------------- the positive's distance

def positive_distance_reference(q, qq, pos, g, gg, *, metric: str, out):
    """Plain version of :func:`positive_distance_cuda`: the positive's
    column of the plain sweep's distances, written into ``out`` (Q,) for
    the queries whose ``pos`` lies in ``[0, N)``."""
    n = g.shape[0]
    p = pos.reshape(-1).long()
    own = (p >= 0) & (p < n)
    d = torch.gather(_distances(q, qq, g, gg, metric), 1,
                     torch.clamp(p, 0, n - 1)[:, None])[:, 0]
    out.copy_(torch.where(own, d, out))
    return out


def positive_distance_cuda(q, qq, pos, g, gg, *, metric: str, out):
    """Launch K1's positive-distance kernel alone on the card (the one
    K1 runs before its sweep, same arithmetic): ``out[i]`` becomes query
    ``i``'s distance to its positive ``pos[i]`` where ``0 <= pos[i] < N``
    and is left as it was elsewhere. Inputs as :func:`fused_sweep_cuda`'s;
    ``out`` (Q,) float32 on the same card."""
    _check_inputs(q, qq, pos, g, gg, out)
    nq, d = q.shape
    if nq == 0:
        return out
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        KERNEL.call("k1_positive_distance", POSITIVE_ARGTYPES, q.data_ptr(),
                    qq.data_ptr(), pos.data_ptr(), g.data_ptr(),
                    gg.data_ptr(), nq, g.shape[0], d, _METRICS[metric],
                    int(g.dtype == torch.bfloat16), out.data_ptr(), stream)
    positive_counters.add(launches=1)
    return out


def positive_distance(q, qq, pos, g, gg, *, metric: str, out):
    """The plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    if g.device.type == "cpu":
        return positive_distance_reference(q, qq, pos, g, gg, metric=metric,
                                           out=out)
    if g.device.type == "cuda":
        return positive_distance_cuda(q, qq, pos, g, gg, metric=metric,
                                      out=out)
    raise ValueError(f"K1 has no route for device {g.device}")


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
    takes them. ``reference=True`` runs the plain versions of the shards'
    kernels on whatever device (the card's yardstick for the kernels).

    The queries' norms are computed once. The positive's distance is
    computed by the shard that owns the positive, with that shard's norms
    (:func:`positive_distance`), and given to every shard, so that a copy
    of the positive in another shard ties with it exactly. Each shard
    sweeps its rows on its own device with the positive's local column
    clipped to ``[-1, N / S]``: -1 (the positive lies before the shard)
    counts strictly closer columns only, N / S (after it) counts the ties
    too, so the rank partials sum to the global rank. Indices become
    global, an unfilled slot's sentinel N / S becomes N, and the (Q, k)
    partials merge by (value, global index)
    (:func:`~art_sbir_tpu_torch.ops.sharded.lexsort_topk_merge`); the
    certificates are ANDed."""
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
    sweep, positive = ((fused_sweep_reference, positive_distance_reference)
                       if reference else (fused_sweep, positive_distance))
    with torch.no_grad():
        q0 = queries.to(dev0)
        qq = query_norms(q0, metric)
        q_op = q0.to(op).contiguous()
        pos = pos_idx.to(dev0, torch.int32).reshape(-1, 1)
        # Each shard's inputs reach its device before any shard's kernel is
        # queued: a copy between cards runs on the source card's stream,
        # behind whatever that card was given before it, so a copy queued
        # after the first shard's sweep would hold every other shard back.
        offs = [i * nl for i in range(mesh.size)]
        on = [(d, q_op.to(d), qq.to(d), g.to(op).contiguous(), gs)
              for d, g, gs in zip(mesh.devices, shards, gg_shards)]
        d2pos = [None] * mesh.size
        if with_ranks:  # from the owner of each (clamped) positive
            owner = torch.clamp(pos, 0, n - 1)
            owned = [(owner - o).to(d) for o, d in zip(offs, mesh.devices)]
            parts = [positive(
                q, qq_d, own, g, gs, metric=metric,
                out=torch.zeros(q.shape[0], dtype=torch.float32, device=d))
                for (d, q, qq_d, g, gs), own in zip(on, owned)]
            # one shard wrote each query's distance, the others left 0
            d2pos = gather_to(parts, dev0).sum(0)
            d2pos = [d2pos.to(d) for d in mesh.devices]
        # the positive's local column (K1 reads it for ranks only)
        pos_local = [(torch.clamp(pos - o, -1, nl) if with_ranks
                      else pos).to(d) for o, d in zip(offs, mesh.devices)]
        outs = [sweep(q, qq_d, p, g, gs, k=k, metric=metric,
                      with_ranks=with_ranks, d2pos=dp)
                for (d, q, qq_d, g, gs), p, dp in zip(on, pos_local, d2pos)]
        if with_ranks:
            ranks = gather_to([o[0] for o in outs], dev0).sum(
                0, dtype=torch.int32)
        else:
            ranks = outs[0][0].to(dev0)  # zeros
        # global indices; an unfilled slot's sentinel nl becomes n
        idx = gather_to([o[2] for o in outs], dev0)
        off = torch.arange(0, n, nl, dtype=idx.dtype, device=dev0)
        idx = torch.where(idx >= nl, n, idx + off[:, None, None])
        vals, idx = lexsort_topk_merge(gather_to([o[1] for o in outs], dev0),
                                       idx, k)
        exact = gather_to([o[3] for o in outs], dev0).amin(0)
    return ranks, vals, idx, exact


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
