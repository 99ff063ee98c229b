"""IVF against the full-scan routes at the serving regime (small
coalesced batches).

Counterpart of the JAX package's ``scripts/probe_ivf.py``. The serving
engine dispatches coalesced micro-batches of about 1 to 32 queries; a
full-scan route reads the whole N x D gallery a dispatch, while the IVF
probe gathers ``B * nprobe * Cpad`` candidate rows whatever N is. Per
dispatch (from dispatch to the host pull of values and indices, the
best of interleaved rounds) it times:

* ``K1 f32``: ``retrieve_fused`` with JAX's arguments, whose default
  precision ``'highest'`` runs K1's float32 form (JAX's label said bf16);
  each call also takes the gallery's squared norms, a pass over it;
* ``K1 f32 gg``: the same given the norms computed once (``gg=``), as
  the serving engine passes them;
* ``K2 r40+rerank``: ``retrieve_quantized_fused`` at ``rerank_factor=4``,
  K2's int8 scan for 40 candidates, then the exact rerank;
* ``ivf p=4/8/16``: ``ivf_search`` at those nprobe;

at B in {1, 4, 8, 32}, with recall@1 and recall@10 of every route
against the exact route (``retrieve_chunked``, float32) for 32 near-row
queries (a gallery row plus 0.1 N(0, 1)) and 32 flat ones (N(0, 1)),
the on-card build time and ``index.stats()``.

    python -m art_sbir_tpu_torch.scripts.probe_ivf [--n 600000] [--d 1024]
        [--nlist 0] [--rounds 6] [--clustered] [--device cuda|cpu]

The gallery comes from a seeded torch generator (JAX's ``jax.random``
stream cannot be reproduced; the shapes and geometry are JAX's):
``--clustered`` draws max(4, sqrt(N)) blob centres 4 N(0, 1) and each row
a centre plus 0.5 N(0, 1), else rows are N(0, 1). ``--device cpu`` runs
the kernels' plain versions and times on the host clock: those times say
nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Sequence

import numpy as np
import torch

from art_sbir_tpu_torch.core.device import (card_fields, ieee_f32,
                                            resolve_device)
from art_sbir_tpu_torch.ops.distance import retrieve_chunked
from art_sbir_tpu_torch.ops.ivf import _generator, build_ivf, ivf_search
from art_sbir_tpu_torch.ops.quant import (quantize_gallery,
                                          retrieve_quantized_fused,
                                          topk_overlap)
from art_sbir_tpu_torch.ops.retrieval_fused import (gallery_norms,
                                                    retrieve_fused)
from art_sbir_tpu_torch.scripts.probe_util import best_ms, log, make_gallery

K = 10
B_MAX = 32
BATCHES = (1, 4, 8, 32)
NPROBES = (4, 8, 16)


def _recall(ids, exact: np.ndarray) -> Dict[str, float]:
    ids = np.asarray(ids)
    return {"at1": float(np.mean(ids[:, 0] == exact[:, 0])),
            "at10": topk_overlap(ids, exact)}


def run(n: int = 600_000, d: int = 1024, nlist: int = 0, rounds: int = 6,
        clustered: bool = False, device="cuda",
        batches: Sequence[int] = BATCHES) -> dict:
    """The probe; returns its readings, and under ``"arrays"`` the
    gallery, its int8 form, the near-row queries and each route's
    (values, indices) for them (the exact route's values are distances,
    K1's squared distances)."""
    dev = resolve_device(device)
    ieee_f32()
    g = make_gallery(n, d, clustered, dev)
    gen_q = _generator(23, dev)
    q_near = g[:B_MAX] + 0.1 * torch.randn((B_MAX, d), generator=gen_q,
                                           device=dev)
    q_flat = torch.randn((B_MAX, d), generator=gen_q, device=dev)
    pos = torch.zeros(B_MAX, dtype=torch.int32, device=dev)
    out = {"n": n, "d": d, "clustered": clustered, "device": str(dev),
           **card_fields(dev),
           "clock": "CUDA events" if dev.type == "cuda" else "host"}

    t0 = time.perf_counter()
    index = build_ivf(g, nlist or None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["build_s"] = time.perf_counter() - t0
    out["stats"] = index.stats()
    log(f"IVF build: {out['build_s']:.1f}s  {out['stats']}")
    qg = quantize_gallery(g, "euclidean")

    # the exact reference top-10 (chunked, float32)
    exact = {}
    for tag, q in (("near", q_near), ("flat", q_flat)):
        _, ev, ei = retrieve_chunked(q, g, pos, k=K, chunk=B_MAX)
        exact[tag] = (ev, ei)
    exact_np = {tag: ei.cpu().numpy() for tag, (_, ei) in exact.items()}

    gg = gallery_norms(g, "euclidean")

    def k1(q, gg=None):
        _, v, i = retrieve_fused(q, g, pos[:len(q)], k=K, with_ranks=False,
                                 device_get=True, gg=gg)
        return v, i

    def k2(q):
        return retrieve_quantized_fused(q, qg, g, k=K, rerank_factor=4,
                                        device_get=True)

    def ivf(q, nprobe):
        v, i = ivf_search(q, index, g, nprobe=nprobe, k=K)
        return v.cpu().numpy(), i.cpu().numpy()

    route_fns = [("K1 f32", k1), ("K1 f32 gg", lambda q: k1(q, gg)),
                 ("K2 r40+rerank", k2)] + [
        (f"ivf p={p}", (lambda q, p=p: ivf(q, p))) for p in NPROBES]
    recall, arrays = {}, {"gallery": g, "queries": q_near, "quantized": qg,
                          "exact": exact["near"]}
    for tag, fn in route_fns:
        recall[tag] = {}
        for qtag, q in (("near", q_near), ("flat", q_flat)):
            v, i = fn(q)
            recall[tag][qtag] = _recall(i, exact_np[qtag])
            if qtag == "near":
                arrays[tag] = (torch.as_tensor(v), torch.as_tensor(i))
        r = recall[tag]
        log(f"recall {tag:<14}: @1 near {r['near']['at1']:.4f} | @10 near "
            f"{r['near']['at10']:.4f} | @10 flat {r['flat']['at10']:.4f}")
    out["recall"] = recall
    out["candidates_per_query"] = {f"ivf p={p}": p * index.pad_width
                                   for p in NPROBES}

    times = {}
    for b in batches:
        qb = q_near[:b]
        best = best_ms([(tag, (lambda fn=fn: fn(qb)))
                        for tag, fn in route_fns], rounds, dev)
        base = best["K1 f32"]
        for tag, _ in route_fns:
            log(f"B={b:>2} {tag:<14} {best[tag]:8.3f} ms/dispatch "
                f"({b / best[tag] * 1e3:9,.0f} qps) | vs K1 "
                f"{base / best[tag]:5.2f}x")
        times[str(b)] = best
    out["ms_per_dispatch"] = times
    out["arrays"] = arrays
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=600_000)
    p.add_argument("--d", type=int, default=1024)
    p.add_argument("--nlist", type=int, default=0,
                   help="0 = auto 2*sqrt(N)")
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--clustered", action="store_true",
                   help="blob-structured gallery (realistic embedding "
                        "geometry) instead of the adversarial flat gaussian")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    res = run(args.n, args.d, args.nlist, args.rounds, args.clustered,
              args.device)
    res.pop("arrays")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
