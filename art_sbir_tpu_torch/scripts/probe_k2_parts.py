"""Where K2's time goes on the card: K2 whole, and with parts of it
switched off.

    python -m art_sbir_tpu_torch.scripts.probe_k2_parts [N] [--reps R]

Builds variants of ``csrc/quant_candidates.cu`` into ``_build/`` and times
each (CUDA events, the mean of ``R`` launches) on a seeded gallery of N
rows (default 1,000,000, D = 1024) at the serving shape and beyond:

  full       K2 as it ships
  no_flush   the selection buffer is emptied, not merged (no flushes)
  no_select  no selection at all: products, epilogue and the merge
  no_merge   no second pass
  products   neither selection nor merge: the gallery stream and products

Only ``full`` returns the right candidates; the others time a part. A
sixth build counts, in one untimed call, the keys the selection admitted
and the buffer flushes per query and split. Prints one JSON line per
(Q, r) with the card's name and power limit. Runs on the card only.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from art_sbir_tpu_torch.core.cuda_build import (BUILD_DIR, CSRC, CudaKernel,
                                                grid_splits)
from art_sbir_tpu_torch.ops import quant
from art_sbir_tpu_torch.ops import quant_fused as qf

D = 1024
SHAPES = ((1, 40), (32, 40), (32, 256), (32, 1024))  # (Q, r)
# (text of csrc/quant_candidates.cu, what replaces it) per part switched off
_FLUSH = ("          nk = flush(v, x, r, B, nk, nb);\n",
          "          nk = min(r, nk + nb);\n")
_SELECT = ("    const unsigned below = (1u << lane) - 1;\n",
           "    const unsigned below = (1u << lane) - 1;\n    continue;\n")
_MERGE = ("  k2_merge<<<", "  if (false) k2_merge<<<")
_COUNTED = (
    ("namespace {\n",
     "__device__ unsigned long long probe_counts[2];\nnamespace {\n"),
    ("        nb += __popc(adm);\n",
     "        nb += __popc(adm);\n"
     "        if (lane == 0) atomicAdd(&probe_counts[0], 1ull * __popc(adm));\n"),
    ("        if (nb + __popc(adm) > B) {\n",
     "        if (nb + __popc(adm) > B) {\n"
     "          if (lane == 0) atomicAdd(&probe_counts[1], 1ull);\n"),
    ("    if (nb) {\n",
     "    if (nb) {\n      if (lane == 0) atomicAdd(&probe_counts[1], 1ull);\n"))
_READ = """
extern "C" int k2_probe_counts(unsigned long long* out) {
  unsigned long long zero[2] = {0, 0};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, probe_counts, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(probe_counts, zero, sizeof(zero));
  return static_cast<int>(err);
}
"""
VARIANTS = {"full": (), "no_flush": (_FLUSH,), "no_select": (_SELECT,),
            "no_merge": (_MERGE,), "products": (_SELECT, _MERGE),
            "counted": _COUNTED}


def variant_kernel(name: str, patches) -> CudaKernel:
    """K2's library built from its source with ``patches`` applied."""
    src = (CSRC / "quant_candidates.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"probe_k2_parts: {old!r} not found once in "
                               "quant_candidates.cu")
        src = src.replace(old, new)
    src = re.sub(r'#include "(\w+\.cuh)"',
                 lambda m: f'#include "{CSRC / m.group(1)}"', src)
    if patches is _COUNTED:
        src += _READ
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"k2_{name}.cu"
    path.write_text(src)
    kernel = CudaKernel(f"k2_{name}", qf.KERNEL.symbol, qf.KERNEL.argtypes,
                        label=f"K2 {name}")
    kernel.source = path
    return kernel


@contextlib.contextmanager
def routed_to(kernel: CudaKernel):
    """``quant_candidates_cuda`` launches ``kernel`` inside the block."""
    saved = qf.KERNEL
    qf.KERNEL = kernel
    qf._first_pass.cache_clear()
    try:
        yield
    finally:
        qf.KERNEL = saved
        qf._first_pass.cache_clear()


def time_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_k2_parts: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels = {name: variant_kernel(name, patches)
               for name, patches in VARIANTS.items()}
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc each, together
        list(pool.map(lambda k: k.build(), kernels.values()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    qg = quant.quantize_gallery(
        torch.randn((args.n, D), generator=gen, device="cuda"))
    for q, r in SHAPES:
        x = torch.randn((q, D), generator=gen, device="cuda")
        q8, s_q = quant._quantize_queries(x, "euclidean")
        inputs = (q8, s_q, qg.q8, qg.scale, qg.sq_norm)
        row = {"q": q, "n": args.n, "r": r, "card": card}
        for name, kernel in kernels.items():
            with routed_to(kernel):
                if name != "counted":
                    row[f"{name}_ms"] = time_ms(lambda: qf.quant_candidates_cuda(
                        *inputs, r=r, metric="euclidean"), args.reps)
                    continue
                qf.quant_candidates_cuda(*inputs, r=r, metric="euclidean")
                counts = (ctypes.c_ulonglong * 2)()
                kernel.call("k2_probe_counts", [ctypes.c_void_p],
                            ctypes.cast(counts, ctypes.c_void_p))
                tq, per_sm = qf._first_pass(r, 0)
                splits = grid_splits(-(-q // tq), -(-args.n // qf._TN),
                                     torch.device("cuda"), per_sm=per_sm)
                row.update(splits=splits, admitted_per_query=counts[0] / q,
                           flushes_per_query_split=counts[1] / (q * splits))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
