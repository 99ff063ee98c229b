"""P1: the ablation probe's stripped forms of K1.

Counterpart of ``_ablate_kernel`` in ``scripts/probe_fused_overhead.py``
(the TPU kernel that strips the fused retrieval kernel level by level, to
measure where its time goes). The kernel is hand-written CUDA for Hopper,
``csrc/fused_ablation.cu``: K1's own bf16 first pass (``csrc/k1_sweep.cuh``)
with its epilogue cut back, so that each level strips the port's K1 and
nothing else. It is compiled with ``nvcc`` at first use into
``art_sbir_tpu_torch/_build/`` and loaded with ``ctypes``.

Contract, level by level, per query row (``out`` (Q, 1) int32):

* the cross term is ``q . g`` of bf16 operands summed in float32;
* level 0 sums, over the ``tile_n``-column tiles of the gallery, the tile's
  float32 row sum of cross terms truncated toward zero to int32 (so the
  result depends on ``tile_n``);
* level 1 counts the rank hits of ``d2 = max(qq + gg - 2 cross, 0)``
  against ``d2pos``: strictly closer, or an exact tie at a smaller index,
  never the positive's own column;
* level 2 adds the count of ``d2 <= 1e-6``. Like the TPU level, the kernel
  also keeps a per-lane running minimum of those distances and folds it
  into the count times 0: bookkeeping to time, which adds nothing.

N must be a multiple of ``tile_n`` (the TPU grid ``n // TILE_N`` drops a
ragged tail; here it raises). Q is free.

:func:`ablate` runs the plain PyTorch version for tensors on the CPU and the
CUDA kernel for tensors on the card; there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from art_sbir_tpu_torch.core.cuda_build import (CudaKernel, LaunchCounters,
                                                grid_splits)

BIG = 3.0e38  # a column past the gallery; no distance reaches it
TILE_N = 1024  # the probe's gallery tile
LEVELS = (0, 1, 2)
LANES = 128  # tile_n comes in multiples of the TPU kernel's 128 lanes

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("fused_ablation", "p1_fused_ablation",
                    [_ptr] * 6 + [_i32] * 6 + [_ptr] * 3 + [_ptr], label="P1")
counters = LaunchCounters()


@functools.lru_cache(maxsize=None)
def first_pass(nq: int, level: int, device_index: int):
    """(queries per block, gallery rows per tile, blocks per SM) of P1's
    first pass (K1's) at ``level`` for ``nq`` queries on the card
    ``device_index``, as the kernel reports them."""
    return KERNEL.ask("p1_first_pass", (nq, level), 3, device_index)


def _check(n: int, level: int, tile_n: int) -> None:
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level}")
    if tile_n < LANES or tile_n % LANES:
        raise ValueError(f"tile_n must be a multiple of {LANES}, got {tile_n}")
    if n % tile_n:
        raise ValueError(f"N={n} must be a multiple of tile_n={tile_n}")


def ablate_reference(q, g, qq, gg, d2pos, pos, *, level: int,
                     tile_n: int = TILE_N) -> torch.Tensor:
    """Plain PyTorch version (the CPU route, and the card's yardstick for
    the kernel). Inputs as :func:`ablate_cuda`; returns (Q, 1) int32."""
    n = g.shape[0]
    _check(n, level, tile_n)
    cross = q.float() @ g.float().T
    if level == 0:
        tiles = torch.sum(cross.reshape(cross.shape[0], n // tile_n, tile_n),
                          dim=2)
        return torch.sum(tiles.to(torch.int32), dim=1,
                         keepdim=True).to(torch.int32)
    d2 = torch.clamp(qq + gg - 2.0 * cross, min=0.0)
    col = torch.arange(n, device=d2.device)[None, :]
    hit = (d2 < d2pos) | ((d2 == d2pos) & (col < pos))
    hit = hit & (d2 < BIG) & (col != pos)
    out = torch.sum(hit, dim=1, keepdim=True)
    if level == 2:
        out = out + torch.sum(d2 <= 1e-6, dim=1, keepdim=True)
    return out.to(torch.int32)


def ablate_cuda(q, g, qq, gg, d2pos, pos, *, level: int,
                tile_n: int = TILE_N) -> torch.Tensor:
    """Launch P1 on the card. ``q`` (Q, D) and ``g`` (N, D) bf16, 16-byte
    aligned with D % 8 == 0; ``qq`` and ``d2pos`` (Q, 1), ``gg`` (1, N)
    float32; ``pos`` (Q, 1) int32; all contiguous on one CUDA device."""
    dev = g.device
    nq, d = q.shape
    n = g.shape[0]
    _check(n, level, tile_n)
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    for name, t, dtype, shape in (
            ("q", q, bf16, (nq, d)), ("g", g, bf16, (n, d)),
            ("qq", qq, f32, (nq, 1)), ("gg", gg, f32, (1, n)),
            ("d2pos", d2pos, f32, (nq, 1)), ("pos", pos, i32, (nq, 1))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"P1 input {name}: want contiguous {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if d % 8 or q.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError(f"P1 reads 16-byte rows of bf16: D={d} must be a "
                         "multiple of 8 and q, g 16-byte aligned")
    out = torch.empty((nq, 1), dtype=i32, device=dev)
    if nq == 0:
        return out
    tq, tn, per_sm = first_pass(nq, level, dev.index)
    if tile_n % tn:
        raise ValueError(f"P1 sums whole {tn}-row tiles: tile_n={tile_n}")
    n_tiles = n // tn
    s = grid_splits(-(-nq // tq), n_tiles, dev, per_sm=per_sm)
    if level == 0:  # one float32 row sum per tile of the kernel
        part_m = torch.empty((n_tiles, nq), dtype=f32, device=dev)
        part_r = torch.empty(0, dtype=i32, device=dev)
    else:
        part_m = torch.empty(0, dtype=f32, device=dev)
        part_r = torch.empty((nq, s), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(q.data_ptr(), qq.data_ptr(), d2pos.data_ptr(),
                      pos.data_ptr(), g.data_ptr(), gg.data_ptr(), nq, n, d,
                      level, tile_n, s, part_m.data_ptr(), part_r.data_ptr(),
                      out.data_ptr(), stream)
    counters.add(launches=1)
    return out


def ablate(q, g, qq, gg, d2pos, pos, *, level: int,
           tile_n: int = TILE_N) -> torch.Tensor:
    """The plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    if g.device.type == "cpu":
        return ablate_reference(q, g, qq, gg, d2pos, pos, level=level,
                                tile_n=tile_n)
    if g.device.type == "cuda":
        return ablate_cuda(q, g, qq, gg, d2pos, pos, level=level,
                           tile_n=tile_n)
    raise ValueError(f"P1 has no route for device {g.device}")
