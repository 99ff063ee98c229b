"""The row-sharded gallery over distinct cards: one shard a card.

    python -m art_sbir_tpu_torch.scripts.probe_sharded_cards [N ...]
    python -m art_sbir_tpu_torch.scripts.probe_sharded_cards --device cpu

On a machine with several cards, over every card present (``data_mesh``;
at least 2): the gallery lives on card 0 and its shards on the cards,
placed once. For each gallery size N (default 100,000 and 1,000,000;
D = 1024, k = 10):

* sharded K1 against unsharded K1 on card 0, bit for bit (ranks, values,
  indices), both forms and both metrics at Q = 32 with ranks, with rows
  copied across shards and positives on them;
* the sharded int8 route (K2 a card, r = 40) against its per-shard plain
  route, bit for bit, Q = 32;
* times, host clock over every card (each card synchronized before and
  after): K1 unsharded and sharded at Q = 32 without ranks and Q = 1,024
  with ranks, float32 form; the int8 route unsharded and sharded at
  Q = 32. Each time is the better of two runs of 10 calls (5 at
  Q = 1,024). Beside each sharded call: its kernel launches (K1's sweep,
  its positive pass, K2, the cross-shard merge; the launch counters over
  one call) and its device time by card (torch.profiler, one call).

One JSON line per N, then each card's name and power limit from
``nvidia-smi``. Any failed check exits non-zero. ``--device cpu`` runs the
same on 4 CPU shards through the plain versions at N = 4,096 and D = 64
(a rehearsal of the control flow; its times are the CPU's).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from art_sbir_tpu_torch.ops import quant
from art_sbir_tpu_torch.ops import quant_fused as qf
from art_sbir_tpu_torch.ops import retrieval_fused as rf
from art_sbir_tpu_torch.parallel.mesh import data_mesh

K, R = 10, 40
COUNTERS = {"K1": rf.counters, "positive": rf.positive_counters,
            "merge": rf.merge_counters, "K2": qf.counters}


def _sync(mesh) -> None:
    for d in mesh.distinct_devices():
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _ms(fn, mesh, reps: int) -> float:
    """Better of two runs of ``reps`` calls, ms a call, host clock over
    every card of the mesh."""
    fn()
    best = float("inf")
    for _ in range(2):
        _sync(mesh)
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(mesh)
        best = min(best, (time.perf_counter() - t) / reps)
    return 1e3 * best


def _device_ms_by_card(fn, mesh) -> dict:
    """Kernel time of one call of ``fn`` by card (torch.profiler), to see
    where each shard's kernels ran."""
    if mesh.devices[0].type != "cuda":
        return {}
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(mesh)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(mesh)
    by = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            key = f"cuda:{ev.device_index}"
            by[key] = by.get(key, 0.0) + ev.self_device_time_total / 1e3
    return by


def _launches(fn) -> dict:
    """The kernel launches of one call of ``fn``, by counter."""
    for c in COUNTERS.values():
        c.reset()
    fn()
    return {name: c.launches for name, c in COUNTERS.items()}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"probe_sharded_cards: FAILED: {what}")


def probe(n: int, d: int, mesh) -> dict:
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(n)
    nl = n // mesh.size
    g = torch.randn((n, d), generator=gen, device=dev0)
    for s in range(1, mesh.size):  # rows 0-15 copied into every shard
        g[s * nl + 100:s * nl + 116] = g[:16]
    out = {"n": n, "d": d, "shards": mesh.size,
           "devices": [str(x) for x in mesh.devices]}

    def queries(q):
        pos = torch.randint(0, n, (q,), generator=gen, device=dev0)
        pos[:2] = torch.tensor([3, nl + 103], device=dev0)
        x = g[pos] + torch.randn((q, d), generator=gen, device=dev0)
        return x.contiguous(), pos

    x, pos = queries(32)
    for metric in ("euclidean", "cosine"):
        gg = rf.gallery_norms(g, metric)
        shards, ggs = rf.shard_gallery(g, mesh, gg, metric)
        for precision in ("highest", "default"):
            kw = dict(k=K, precision=precision, metric=metric,
                      with_ranks=True)
            one = rf.retrieve_fused_core(x, g, pos, gg=gg, **kw)
            got = rf.retrieve_fused_sharded_core(x, shards, pos, mesh,
                                                 gg=ggs, **kw)
            _check(all(torch.equal(a, b.to(a.device))
                       for a, b in zip(one, got)),
                   f"sharded K1 = unsharded K1 ({n} {metric} {precision})")
        del shards, ggs
    out["k1_bit_equal_cases"] = 4

    gg = rf.gallery_norms(g, "euclidean")
    shards, ggs = rf.shard_gallery(g, mesh, gg)
    times = []
    for q, with_ranks, reps in ((32, False, 10), (1024, True, 5)):
        x, pos = queries(q)
        kw = dict(k=K, with_ranks=with_ranks)

        def sharded():
            return rf.retrieve_fused_sharded_core(x, shards, pos, mesh,
                                                  gg=ggs, **kw)

        times.append({
            "q": q, "with_ranks": with_ranks,
            "unsharded_ms": _ms(lambda: rf.retrieve_fused_core(
                x, g, pos, gg=gg, **kw), mesh, reps),
            "sharded_ms": _ms(sharded, mesh, reps),
            "launches": _launches(sharded),
            "device_ms_by_card": _device_ms_by_card(sharded, mesh),
            "unsharded_device_ms": _device_ms_by_card(
                lambda: rf.retrieve_fused_core(x, g, pos, gg=gg, **kw),
                mesh)})
    out["k1_times"] = times
    del shards, ggs

    rows = torch.randint(0, n, (32,), generator=gen, device=dev0)
    x = g[rows] + 0.01 * torch.randn((32, d), generator=gen, device=dev0)
    qg = quant.quantize_gallery(g, "euclidean")
    qgs, gs = quant.shard_quant_gallery(qg, g, mesh)
    kw = dict(k=K, rerank_factor=R // K)
    qf.counters.reset()
    v1, i1 = quant.retrieve_quantized_sharded(x, qgs, gs, mesh, **kw)
    on_card = sum(dev.type == "cuda" for dev in mesh.distinct_devices())
    _check(qf.counters.launches == on_card and qf.counters.fallback_rows == 0,
           f"K2 once a card, no fallback ({n})")
    v0, i0 = quant.retrieve_quantized_sharded(x, qgs, gs, mesh,
                                              use_kernel=False, **kw)
    _check(torch.equal(v1, v0) and torch.equal(i1, i0),
           f"sharded int8 route = its per-shard plain route ({n})")
    _check(torch.equal(g[i1[:, 0].long()], g[rows]),
           f"sharded int8 route: the query's row (or a copy) first ({n})")
    out["int8_route"] = {
        "unsharded_ms": _ms(lambda: quant.retrieve_quantized_fused(
            x, qg, g, **kw) if dev0.type == "cuda"
            else quant.retrieve_quantized(x, qg, g, **kw), mesh, 10),
        "sharded_ms": _ms(lambda: quant.retrieve_quantized_sharded(
            x, qgs, gs, mesh, **kw), mesh, 10)}
    out["int8_launches"] = _launches(
        lambda: quant.retrieve_quantized_sharded(x, qgs, gs, mesh, **kw))
    out["int8_device_ms_by_card"] = _device_ms_by_card(
        lambda: quant.retrieve_quantized_sharded(x, qgs, gs, mesh, **kw),
        mesh)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="*", type=int, default=None,
                   help="gallery rows (divisible by the card count)")
    p.add_argument("--device", default="cuda",
                   help="'cpu': 4 CPU shards through the plain versions")
    args = p.parse_args(argv)
    if args.device == "cpu":
        mesh, d, ns = data_mesh(4, device="cpu"), 64, args.n or [4096]
    else:
        mesh, d = data_mesh(-1), 1024
        ns = args.n or [100_000, 1_000_000]
        if mesh.size < 2:
            print(f"probe_sharded_cards: wants at least 2 cards, found "
                  f"{mesh.size}", file=sys.stderr)
            return 1
    with torch.no_grad():
        for n in ns:
            print(json.dumps(probe(n, d, mesh)), flush=True)
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
