"""Where one call of each row-sharded retrieval form spends its time.

    python -m art_sbir_tpu_torch.scripts.probe_sharded_profile
    python -m art_sbir_tpu_torch.scripts.probe_sharded_profile --cards
    python -m art_sbir_tpu_torch.scripts.probe_sharded_profile --device cpu

Three calls, each beside its unsharded counterpart, D = 1024, k = 10:

* sharded K1, float32 form, Q = 32 without ranks, N = 100,000;
* sharded K1, Q = 1,024 with ranks, N = 100,000;
* the sharded int8 route, Q = 32, r = 40 a shard, N = 1,000,000.

The mesh is 4 shards of card 0 (``chip_smoke.py``'s), or with ``--cards``
one shard on each card present (at least 2). Each call is warmed up, then
profiled once with torch.profiler (host and device): every device
operation in time order (kernels, copies, fills) with its card and device
time, the count of each kind, the device time summed, the call's wall
time (host clock, every card synchronized), and the time between the
first device operation's start and the last one's end during which no
card ran any (the host between them). One JSON line a call, then each
card's name and power limit from ``nvidia-smi``. ``--device cpu`` runs
the control flow on 4 CPU shards at N = 4,096, D = 64 (no device events).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from art_sbir_tpu_torch.ops import quant
from art_sbir_tpu_torch.ops import retrieval_fused as rf
from art_sbir_tpu_torch.parallel.mesh import MeshSpec, data_mesh

K, R = 10, 40


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _kind(name: str) -> str:
    low = name.lower()
    if "memcpy" in low:
        return "copy"
    if "memset" in low:
        return "fill"
    return "kernel"


def profile_call(fn, devices) -> dict:
    """One profiled call of ``fn`` after two warm-up calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    _sync(devices)
    t = time.perf_counter()
    fn()
    _sync(devices)
    wall_ms = 1e3 * (time.perf_counter() - t)
    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        _sync(devices)
    ops = sorted(((ev.time_range.start, ev.time_range.end, ev.name,
                   ev.device_index) for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA),
                 key=lambda o: o[0])
    counts = {"kernel": 0, "copy": 0, "fill": 0}
    busy_end, gaps = None, 0.0
    for start, end, name, _ in ops:
        counts[_kind(name)] += 1
        if busy_end is not None and start > busy_end:
            gaps += start - busy_end
        busy_end = end if busy_end is None else max(busy_end, end)
    return {"wall_ms": wall_ms,
            "device_ms": sum(e - s for s, e, _, _ in ops) / 1e3,
            "span_ms": (ops[-1][1] - ops[0][0]) / 1e3 if ops else 0.0,
            "idle_between_ms": gaps / 1e3, "device_ops": len(ops),
            "counts": counts,
            "ops": [[name[:70], f"cuda:{dev}", round((e - s) / 1e3, 4)]
                    for s, e, name, dev in ops]}


def run(mesh, n_k1: int, n_int8: int, d: int) -> list:
    dev0 = mesh.devices[0]
    devices = mesh.distinct_devices()
    gen = torch.Generator(device=dev0).manual_seed(18)
    lines = []
    g = torch.randn((n_k1, d), generator=gen, device=dev0)
    gg = rf.gallery_norms(g, "euclidean")
    shards, ggs = rf.shard_gallery(g, mesh, gg)
    for q, with_ranks in ((32, False), (1024, True)):
        pos = torch.randint(0, n_k1, (q,), generator=gen, device=dev0)
        x = (g[pos] + torch.randn((q, d), generator=gen,
                                  device=dev0)).contiguous()
        kw = dict(k=K, with_ranks=with_ranks)
        lines.append({
            "call": "K1_sharded", "q": q, "n": n_k1, "with_ranks": with_ranks,
            "sharded": profile_call(lambda: rf.retrieve_fused_sharded_core(
                x, shards, pos, mesh, gg=ggs, **kw), devices),
            "unsharded": profile_call(lambda: rf.retrieve_fused_core(
                x, g, pos, gg=gg, **kw), [dev0])})
    del g, gg, shards, ggs
    g = torch.randn((n_int8, d), generator=gen, device=dev0)
    rows = torch.randint(0, n_int8, (32,), generator=gen, device=dev0)
    x = g[rows] + 0.01 * torch.randn((32, d), generator=gen, device=dev0)
    qg = quant.quantize_gallery(g, "euclidean")
    qgs, gs = quant.shard_quant_gallery(qg, g, mesh)
    kw = dict(k=K, rerank_factor=R // K)
    unsharded = (quant.retrieve_quantized_fused if dev0.type == "cuda"
                 else quant.retrieve_quantized)
    lines.append({
        "call": "int8_sharded", "q": 32, "n": n_int8, "r": R,
        "sharded": profile_call(lambda: quant.retrieve_quantized_sharded(
            x, qgs, gs, mesh, **kw), devices),
        "unsharded": profile_call(lambda: unsharded(x, qg, g, **kw),
                                  [dev0])})
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", action="store_true",
                   help="one shard on each card present (at least 2)")
    p.add_argument("--device", default="cuda",
                   help="'cpu': 4 CPU shards, a rehearsal")
    args = p.parse_args(argv)
    if args.device == "cpu":
        mesh, sizes = data_mesh(4, device="cpu"), (4096, 4096, 64)
    else:
        if args.cards:
            mesh = data_mesh(-1)
            if mesh.size < 2:
                print("probe_sharded_profile: --cards wants at least 2 "
                      f"cards, found {mesh.size}", file=sys.stderr)
                return 1
        else:
            mesh = MeshSpec(4).build(["cuda:0"] * 4)
        sizes = (100_000, 1_000_000, 1024)
    with torch.no_grad():
        for line in run(mesh, *sizes):
            line["mesh"] = [str(x) for x in mesh.devices]
            print(json.dumps(line), flush=True)
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
