"""K2: the streaming int8 candidate scan.

Counterpart of ``quant_candidates_fused`` and ``_quant_jit`` in
``art_sbir_tpu/ops/retrieval_pallas.py`` (the TPU kernel
``_quant_kernel``). The kernel is hand-written CUDA for Hopper,
``csrc/quant_candidates.cu``; its note says what bounds it. It is compiled
with ``nvcc`` at first use into ``art_sbir_tpu_torch/_build/`` and loaded
with ``ctypes`` (:mod:`art_sbir_tpu_torch.core.cuda_build`).

Contract: for each query, the ``r`` gallery rows with the smallest
approximate score of :func:`art_sbir_tpu_torch.ops.quant._quant_core`,
``g_sq - 2 * float(q8 . g8) * (s_q * g_scale)`` (euclidean) or ``-float(q8
. g8) * (s_q * g_scale)`` (cosine), as (scores, int32 indices) ascending by
(score, index): among equal scores the smaller index wins, as in
``lax.top_k``. The third output is the per-row certificate of the TPU
kernel; both routes here are exact by construction and return ones.

:func:`quant_candidates_fused` runs the plain PyTorch version for tensors
on the CPU and the CUDA kernel for tensors on the card; there is no
fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from art_sbir_tpu_torch.core.cuda_build import (CudaKernel, LaunchCounters,
                                                Plans, grid_splits, scratch,
                                                signature)

R_MAX = 1024  # the CUDA kernel's candidate budget, the JAX default's 8 * 128
# The largest r for which the serving engine takes K2. The JAX engine stops
# at 128, the budget it measured on the TPU (art_sbir_tpu/retrieval/
# server.py:508-519); on an H100 K2's route beat the plain int8 scan's at
# every r up to R_MAX at Q = 1 and 32, N = 10^6 (PERF.md, PR 5)
ENGINE_R_MAX = R_MAX
F32_EXACT_DIM = 1040  # D * 127**2 < 2**24: a float32 sum of D int8 products is exact
_TN = 128  # gallery rows per tile; csrc/quant_candidates.cu TN
_VEC = 16  # bytes per staging load; D % 16 == 0
_METRICS = {"euclidean": 0, "cosine": 1}

MAX_SHARDS = 16  # shards of one device in one launch; csrc MAX_SHARDS

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("quant_candidates", "k2_quant_candidates",
                    [_ptr] * 5 + [_i32] * 6 + [_ptr] * 6 + [_ptr], label="K2")
SHARDS_ARGTYPES = [_ptr] * 6 + [_i32] * 8 + [_ptr] * 7
counters = LaunchCounters()  # K2 launches: one a call, or one a device's shards
_PLANS = Plans()  # the shards' checks and pointer arrays, by signature


@functools.lru_cache(maxsize=None)
def _first_pass(r: int, device_index: int):
    """(queries per block, blocks per SM) of K2's first pass for a budget
    of ``r`` on the card ``device_index``, as the kernel's occupancy
    reports them."""
    return KERNEL.ask("k2_first_pass", (r,), 2, device_index)


def sliced_int8_cross(q8: torch.Tensor, g8: torch.Tensor,
                      width: int = F32_EXACT_DIM) -> torch.Tensor:
    """(Q, D) x (N, D) int8 -> (Q, N) int32 ``q8 . g8``, as float32
    products over column slices of at most ``width`` columns, each slice's
    result converted to int32 and the slices added in int32.

    Each slice is exact whether or not ``torch.backends.cuda.matmul.
    allow_tf32`` is set: an int8 value is exact in TF32 (and in float32),
    the product of two is exact in float32, and a slice's sum of at most
    ``width`` products stays below 2^24 (1,040 * 127^2 < 2^24), so no
    partial sum rounds. The int32 sum of the slices is then the exact
    integer product for any D (while D * 127^2 < 2^31)."""
    total = None
    for d0 in range(0, q8.shape[1], width):
        part = (q8[:, d0:d0 + width].float()
                @ g8[:, d0:d0 + width].float().T).to(torch.int32)
        total = part if total is None else total + part
    return total


def int8_cross(q8: torch.Tensor, g8: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (N, D) int8 -> (Q, N) exact cross term ``q8 . g8``, as
    JAX's ``dot_general(..., preferred_element_type=int32)``.

    On the CPU an int32 matrix product. On the card ``torch.matmul`` has
    no integer path (and ``torch._int_mm`` wants more than 16 rows), so
    :func:`sliced_int8_cross` takes it exactly in float32 slices; the
    int32 sum comes back as float32, as ``.astype(float32)`` gives it."""
    if q8.device.type == "cpu":
        return q8.int() @ g8.int().T
    return sliced_int8_cross(q8, g8).float()


def approx_scores(q8, s_q, g8, g_scale, g_sq, metric: str) -> torch.Tensor:
    """(Q, N) approximate scores in ``_quant_core``'s float32 op order."""
    dot = int8_cross(q8, g8).float() * (s_q[:, None] * g_scale[None, :])
    if metric == "euclidean":
        return g_sq[None, :] - 2.0 * dot  # |q|^2 is rank-constant
    return -dot  # 1 - sim ranks like -sim


def quant_candidates_reference(q8, s_q, g8, g_scale, g_sq, *, r: int,
                               metric: str):
    """Plain PyTorch version (the CPU route, and the card's yardstick for
    the kernel): (scores (Q, r), indices (Q, r) int32, ones (Q,) int32),
    ascending by (score, index)."""
    approx = approx_scores(q8, s_q, g8, g_scale, g_sq, metric)
    vals, order = torch.sort(approx, dim=1, stable=True)
    ones = torch.ones(q8.shape[0], dtype=torch.int32, device=q8.device)
    return vals[:, :r], order[:, :r].to(torch.int32), ones


def quant_candidates_cuda(q8, s_q, g8, g_scale, g_sq, *, r: int, metric: str):
    """Launch K2 on the card. ``q8`` (Q, D) and ``g8`` (N, D) int8, 16-byte
    aligned with D % 16 == 0; ``s_q`` (Q,), ``g_scale`` and ``g_sq`` (N,)
    float32; all contiguous on one CUDA device; 1 <= r <= min(1024, N)."""
    dev = g8.device
    nq, d = q8.shape
    n = g8.shape[0]
    f32, i32, i8 = torch.float32, torch.int32, torch.int8
    for name, t, dtype, shape in (
            ("q8", q8, i8, (nq, d)), ("s_q", s_q, f32, (nq,)),
            ("g8", g8, i8, (n, d)), ("g_scale", g_scale, f32, (n,)),
            ("g_sq", g_sq, f32, (n,))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"K2 input {name}: want contiguous {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if d % _VEC or q8.data_ptr() % _VEC or g8.data_ptr() % _VEC:
        raise ValueError(f"K2 reads 16-byte rows: D={d} must be a multiple "
                         "of 16 and q8, g8 16-byte aligned")
    if not 1 <= r <= min(n, R_MAX):
        raise ValueError(f"K2 takes 1 <= r <= min(N={n}, {R_MAX}), got {r}")
    vals = torch.empty((nq, r), dtype=f32, device=dev)
    idx = torch.empty((nq, r), dtype=i32, device=dev)
    exact = torch.empty(nq, dtype=i32, device=dev)
    if nq == 0:
        return vals, idx, exact
    tq, per_sm = _first_pass(r, dev.index)
    s = grid_splits(-(-nq // tq), -(-n // _TN), dev, per_sm=per_sm)
    part_v = torch.empty((nq, s, r), dtype=f32, device=dev)
    part_i = torch.empty((nq, s, r), dtype=i32, device=dev)
    bounds = torch.empty(nq * (s + 1), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(q8.data_ptr(), s_q.data_ptr(), g8.data_ptr(),
                      g_scale.data_ptr(), g_sq.data_ptr(), nq, n, d, r,
                      _METRICS[metric], s, part_v.data_ptr(),
                      part_i.data_ptr(), bounds.data_ptr(),
                      vals.data_ptr(), idx.data_ptr(),
                      exact.data_ptr(), stream)
    counters.add(launches=1)
    return vals, idx, exact


def kernel_takes(device: torch.device, r: int, dim: int) -> bool:
    """Whether K2 runs for a gallery on ``device`` with ``r`` candidates
    per query and ``dim`` columns: on the card, r within the engine's
    envelope (``ENGINE_R_MAX``) and 16-byte rows. The serving engine routes
    by it."""
    return device.type == "cuda" and r <= ENGINE_R_MAX and dim % _VEC == 0


def quant_candidates_fused(q8, s_q, g8, g_scale, g_sq, r: int,
                           metric: str = "euclidean"):
    """(approx_scores, cand_idx, exact): each row's ``r`` best gallery
    indices by the int8 approximate score.

    Inputs are pre-quantized (``ops.quant.quantize_gallery`` /
    ``_symmetric_quantize``)."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r} (euclidean|cosine)")
    n = g8.shape[0]
    if r > n:
        raise ValueError(f"r={r} exceeds gallery size {n}")
    if g8.device.type == "cpu":
        return quant_candidates_reference(q8, s_q, g8, g_scale, g_sq, r=r,
                                          metric=metric)
    if g8.device.type == "cuda":
        return quant_candidates_cuda(q8, s_q, g8, g_scale, g_sq, r=r,
                                     metric=metric)
    raise ValueError(f"K2 has no route for device {g8.device}")


# ------------------------------------------- the shards of one device

def quant_candidates_shards_reference(q8, s_q, shards, row0, *, r: int,
                                      metric: str):
    """Plain version of :func:`quant_candidates_shards_cuda`: each shard's
    :func:`quant_candidates_reference`, its r candidates put in index order
    as global rows (the scores moved with them)."""
    vals, idx = [], []
    for s, first in zip(shards, row0):
        v, i, _ = quant_candidates_reference(q8, s_q, s.q8, s.scale,
                                             s.sq_norm, r=r, metric=metric)
        i, order = torch.sort(i, dim=1)
        vals.append(torch.gather(v, 1, order))
        idx.append(i + first)
    ones = torch.ones((len(shards), q8.shape[0]), dtype=torch.int32,
                      device=q8.device)
    return torch.stack(vals, 1), torch.stack(idx, 1), ones


def quant_candidates_shards_cuda(q8, s_q, shards, row0, *, r: int,
                                 metric: str):
    """Launch K2 once over the C shards of one card: ``shards`` C
    ``QuantGallery``s of N / C rows (their ``q8``, ``scale``, ``sq_norm``
    as :func:`quant_candidates_cuda` takes them), ``row0`` their first
    global rows; 1 <= r <= min(1024, N / C). Returns (scores (Q, C, r),
    indices (Q, C, r) int32, certificates (C, Q) int32): each shard's r
    best by (score, index), in index order as global rows."""
    dev = q8.device
    nq, d = q8.shape
    f32, i32, i8 = torch.float32, torch.int32, torch.int8
    tensors = [t for x in shards for t in (x.q8, x.scale, x.sq_norm)]

    def make():  # the shards' checks, once a signature
        c, nl = len(shards), int(shards[0].q8.shape[0])
        if not 1 <= c <= MAX_SHARDS or len(row0) != c:
            raise ValueError(f"K2 takes 1 to {MAX_SHARDS} shards a launch "
                             f"with their first rows, got {c} and "
                             f"{len(row0)}")
        for x in shards:
            for t, dtype, shape in ((x.q8, i8, (nl, d)), (x.scale, f32, (nl,)),
                                    (x.sq_norm, f32, (nl,))):
                if (t.device != dev or t.dtype != dtype
                        or tuple(t.shape) != shape or not t.is_contiguous()):
                    raise ValueError(
                        f"K2 shard: want contiguous {dtype} {shape} on "
                        f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                        f"{t.device}")
            if x.q8.data_ptr() % _VEC:
                raise ValueError("K2 reads 16-byte rows: shards 16-byte "
                                 "aligned")

        def ptrs(name):
            return (_ptr * c)(*[getattr(x, name).data_ptr() for x in shards])

        return (c, nl, ptrs("q8"), ptrs("scale"), ptrs("sq_norm"),
                (_i32 * c)(*row0))

    c, nl, g8_arr, scale_arr, sq_arr, row0_arr = _PLANS.get(
        (tuple(row0), dev, d) + signature(tensors), make)
    for name, t, dtype, shape in (("q8", q8, i8, (nq, d)),
                                  ("s_q", s_q, f32, (nq,))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"K2 input {name}: want contiguous {dtype} "
                             f"{shape} on {dev}")
    if d % _VEC or q8.data_ptr() % _VEC:
        raise ValueError(f"K2 reads 16-byte rows: D={d} must be a multiple "
                         "of 16 and q8 16-byte aligned")
    if not 1 <= r <= min(nl, R_MAX):
        raise ValueError(f"K2 takes 1 <= r <= min(N={nl}, {R_MAX}), got {r}")
    vals = torch.empty((nq, c, r), dtype=f32, device=dev)
    idx = torch.empty((nq, c, r), dtype=i32, device=dev)
    exact = torch.empty((c, nq), dtype=i32, device=dev)
    if nq == 0:
        return vals, idx, exact
    tq, per_sm = _first_pass(r, dev.index)
    n_tiles = -(-nl // _TN)
    total = grid_splits(-(-nq // tq), c * n_tiles, dev, per_sm=per_sm)
    s = max(1, min(n_tiles, total // c))
    # part_v, part_i (Q, C * s, r) and the bounds (C * Q * (s + 1),) 64-bit
    step = 4 * nq * c * s * r
    buf = scratch(dev, 2 * step + 8 * c * nq * (s + 1))
    base = buf.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.call("k2_quant_candidates_shards", SHARDS_ARGTYPES,
                    q8.data_ptr(), s_q.data_ptr(), g8_arr, scale_arr, sq_arr,
                    row0_arr, c, nq, nl, d, r,
                    _METRICS[metric], s, 1, base, base + step,
                    base + 2 * step, vals.data_ptr(), idx.data_ptr(),
                    exact.data_ptr(), stream)
    counters.add(launches=1)
    return vals, idx, exact


def quant_candidates_shards(q8, s_q, shards, row0, *, r: int,
                            metric: str = "euclidean"):
    """The plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r} (euclidean|cosine)")
    if q8.device.type == "cpu":
        return quant_candidates_shards_reference(q8, s_q, shards, row0, r=r,
                                                 metric=metric)
    if q8.device.type == "cuda":
        return quant_candidates_shards_cuda(q8, s_q, shards, row0, r=r,
                                            metric=metric)
    raise ValueError(f"K2 has no route for device {q8.device}")
