"""Ablation probe of K1: where does the fused retrieval kernel's time go?

Counterpart of the JAX package's ``scripts/probe_fused_overhead.py``. On a
seeded bf16 gallery it times, interleaved, the minimum over rounds of one
call each (CUDA events):

  mm        P1 level 0: K1's bf16 cross term only
  rank      P1 level 1: + the distances and the rank hits
  top2      P1 level 2: + the count of distances <= 1e-6
  full      K1, ``retrieve_fused(..., precision='default')``
  full_f32  K1, ``retrieve_fused(..., precision='highest')`` on float32 copies
  xla       the chunked plain route, ``retrieve_chunked(...,
            precision='default', chunk=256)`` (the JAX probe's XLA baseline)

and prints each one's time and its share of ``full``. Both K1
configurations get the gallery's norms computed once, as the serving engine
passes them (``gg=``), so that they time the sweep and not a per-call pass
over the gallery.

    python -m art_sbir_tpu_torch.scripts.probe_fused_overhead [N] [Q] [rounds]
        [--device cuda|cpu]

Defaults 1,000,000 rows, 4,096 queries, 5 rounds, D = 1024. N is rounded
down to a multiple of P1's 1,024-row tile. ``--device cpu`` runs the plain
versions and times them on the host clock: those times say nothing of the
card.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict

import torch

from art_sbir_tpu_torch.core.device import resolve_device
from art_sbir_tpu_torch.ops import fused_ablation as fa
from art_sbir_tpu_torch.ops import retrieval_fused as rf
from art_sbir_tpu_torch.ops.distance import retrieve_chunked

D = 1024
K = 10
CONFIGS = ("mm", "rank", "top2", "full", "full_f32", "xla")


def make_inputs(n: int, nq: int, device: torch.device, seed: int = 0):
    """The JAX probe's inputs: a bf16 gallery and bf16 queries of standard
    normals; ``qq`` and ``gg`` plain squared norms of the bf16 values (no
    eps fold); positives ``arange(Q)`` at ``d2pos = 1e-9``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn((n, D), generator=gen, device=device).to(torch.bfloat16)
    q = torch.randn((nq, D), generator=gen, device=device).to(torch.bfloat16)
    p = torch.arange(nq, dtype=torch.int32, device=device)
    qq = torch.sum(q.float() ** 2, dim=1, keepdim=True)
    gg = torch.sum(g.float() ** 2, dim=1)[None, :]
    d2pos = torch.full((nq, 1), 1e-9, dtype=torch.float32, device=device)
    return q, g, p, qq, gg, d2pos


def configs(q, g, p, qq, gg, d2pos) -> Dict[str, Callable]:
    pos2d = p[:, None].contiguous()
    q32, g32 = q.float(), g.float()
    norms = rf.gallery_norms(g, "euclidean")  # the same for g32

    def level(lv):
        return lambda: fa.ablate(q, g, qq, gg, d2pos, pos2d, level=lv)

    return {
        "mm": level(0),
        "rank": level(1),
        "top2": level(2),
        "full": lambda: rf.retrieve_fused(q, g, p, k=K, precision="default",
                                          gg=norms),
        "full_f32": lambda: rf.retrieve_fused(q32, g32, p, k=K,
                                              precision="highest", gg=norms),
        "xla": lambda: retrieve_chunked(q32, g32, p, k=K, precision="default",
                                        chunk=256),
    }


def _time_ms(fn: Callable, device: torch.device) -> float:
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def run(n: int = 1_000_000, nq: int = 4096, rounds: int = 5,
        device: str | torch.device | None = None, log=print) -> dict:
    """Time every configuration, interleaved, ``rounds`` times after one
    warm-up call each (which builds the kernels); return the minimum of
    each, in ms, and its share of ``full``."""
    dev = resolve_device(device)
    if n % fa.TILE_N:
        log(f"N={n} rounded down to {n - n % fa.TILE_N}, a multiple of "
            f"P1's {fa.TILE_N}-row tile")
        n -= n % fa.TILE_N
    if n < fa.TILE_N or nq < 1 or rounds < 1:
        raise ValueError(f"need N >= {fa.TILE_N}, Q >= 1 and rounds >= 1")
    with torch.no_grad():
        cfgs = configs(*make_inputs(n, nq, dev))
        for fn in cfgs.values():
            fn()
        best = {name: float("inf") for name in cfgs}
        for r in range(rounds):
            for name, fn in cfgs.items():
                ms = _time_ms(fn, dev)
                best[name] = min(best[name], ms)
                log(f"  r{r} {name:8s}: {ms:10.3f} ms")
    clock = ("CUDA events on " + torch.cuda.get_device_name(dev)
             if dev.type == "cuda" else "host clock on the CPU")
    return {"n": n, "q": nq, "d": D, "k": K, "rounds": rounds, "clock": clock,
            "ms": best,
            "share_of_full": {name: ms / best["full"]
                              for name, ms in best.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("q", nargs="?", type=int, default=4096)
    ap.add_argument("rounds", nargs="?", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.n, args.q, args.rounds, args.device)
    print(f"\nN={res['n']} Q={res['q']} D={res['d']} k={res['k']}, min over "
          f"{res['rounds']} rounds, {res['clock']}")
    for name in CONFIGS:
        print(f"{name:8s}: {res['ms'][name]:10.3f} ms  "
              f"{res['share_of_full'][name]:7.3f} of full")
    return 0


if __name__ == "__main__":
    sys.exit(main())
