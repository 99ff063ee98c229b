"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build    -- compile K1 (csrc/fused_retrieval.cu) with nvcc; the card's
               name and power limit from nvidia-smi.
2. kernels  -- K1 against its plain PyTorch version on the card
               (D = 1024, k = 10, N in {100000, 100003}, Q in {1, 32, 512},
               both metrics, ranks on and off, a case with duplicated
               gallery rows), and K1's times at the serving shape.
3. encoder  -- the full-width ModifiedResNet50 forward, bf16, batch 32 at
               224 px: finite outputs, cosine similarity to float32 (TF32
               off), images/s.
4. serve    -- the serving path at full width: a 100,000 x 1024 feature
               cache with 8 planted rows, ``cli/serve.py::build_engine``
               on the card, warmup, then /healthz, 20 rounds of 8
               concurrent /search and one /search_batch of 8 over HTTP
               (then one dispatch under torch.profiler, outside the
               counted run). Each top-1 must be its
               planted row; K1 must have been launched and never fallen
               back. K1's launch count in the kernels line comes from
               this phase alone.

Any failed check exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
D, K = 1024, 10
SERVE_N = 100_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ build

def phase_build(state) -> None:
    from art_sbir_tpu_torch.ops import retrieval_fused as rf

    t0 = time.perf_counter()
    lib = rf.build_library()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    import importlib.util

    import torch

    state["card"] = card_line()
    state["pil"] = importlib.util.find_spec("PIL") is not None
    emit({"phase": "build", "ok": True, "nvcc_s": secs,
          "library": lib.name, "ptxas": ptxas, "card": state["card"],
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "pil": state["pil"]})


# ---------------------------------------------------------------- kernels

def _k1_inputs(n, q, metric, gen, ties=False):
    import torch

    from art_sbir_tpu_torch.ops.retrieval_fused import (gallery_norms,
                                                        query_norms)

    dev = torch.device("cuda")
    g = torch.randn((n, D), generator=gen, device=dev)
    if ties:  # rows [n//2, n//2 + 64) duplicate rows [0, 64)
        g[n // 2:n // 2 + 64] = g[:64]
    pos = torch.randint(0, n, (q,), generator=gen, device=dev)
    if ties:
        pos = torch.arange(q, device=dev) % 64
    noise = torch.randn((q, D), generator=gen, device=dev)
    queries = (g[pos] + (0.05 if ties else 1.0) * noise).contiguous()
    qq, gg = query_norms(queries, metric), gallery_norms(g, metric)
    pos2d = pos.to(torch.int32).reshape(-1, 1).contiguous()
    return queries, qq, pos2d, g, gg


def _compare(out, ref, q, n, with_ranks):
    r1, v1, i1, e1 = (t.cpu().numpy() for t in out)
    r0, v0, i0, _ = (t.cpu().numpy() for t in ref)
    check(e1.all(), "K1 certificate")
    check((np.sort(i1, 1) == np.sort(i0, 1)).all(), "K1 top-k index sets")
    check(np.allclose(v1, v0, rtol=1e-5, atol=1e-6), "K1 values rtol 1e-5")
    # rows ordered by (value, index), strictly
    key_ok = (v1[:, 1:] > v1[:, :-1]) | ((v1[:, 1:] == v1[:, :-1])
                                         & (i1[:, 1:] > i1[:, :-1]))
    check(key_ok.all(), "K1 (value, index) order")
    rank_err = int(np.abs(r1.astype(np.int64) - r0).max()) if q else 0
    check(rank_err <= 2 if with_ranks else not r1.any(), "K1 ranks within 2")
    return float(np.abs(v1 - v0).max()), rank_err, int((i1 != i0).sum())


def phase_kernels(state) -> None:
    import torch

    from art_sbir_tpu_torch.ops import retrieval_fused as rf

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, max_err = [], 0.0
    for n in (SERVE_N, SERVE_N + 3):
        for metric in ("euclidean", "cosine"):
            for q in (1, 32, 512):
                inputs = _k1_inputs(n, q, metric, gen)
                for with_ranks in (True, False):
                    kw = dict(k=K, metric=metric, with_ranks=with_ranks)
                    out = rf.fused_sweep_cuda(*inputs, **kw)
                    ref = rf.fused_sweep_reference(*inputs, **kw)
                    torch.cuda.synchronize()
                    err, rank_err, moved = _compare(out, ref, q, n, with_ranks)
                    max_err = max(max_err, err)
                    cases.append([n, q, metric, with_ranks, err, rank_err,
                                  moved])
                del inputs
    # manufactured ties: duplicated rows tie exactly, the smaller index first
    inputs = _k1_inputs(SERVE_N, 32, "euclidean", gen, ties=True)
    out = rf.fused_sweep_cuda(*inputs, k=K, metric="euclidean",
                              with_ranks=True)
    ref = rf.fused_sweep_reference(*inputs, k=K, metric="euclidean",
                                   with_ranks=True)
    _compare(out, ref, 32, SERVE_N, True)
    v1, i1 = out[1].cpu().numpy(), out[2].cpu().numpy()
    for row in range(32):
        p = row % 64
        idx = list(i1[row])
        check(p in idx and p + SERVE_N // 2 in idx, "ties: both copies kept")
        a, b = idx.index(p), idx.index(p + SERVE_N // 2)
        check(b == a + 1 and v1[row, a] == v1[row, b],
              "ties: exact tie, smaller index first")
    # the positive's later copy: its earlier twin ties exactly and counts
    queries, qq, pos2d, g, gg = inputs
    later = rf.fused_sweep_cuda(queries, qq, pos2d + SERVE_N // 2, g, gg,
                                k=K, metric="euclidean", with_ranks=True)
    check(bool((later[0] == out[0] + 1).all()),
          "ties: the positive's earlier duplicate counts toward its rank")
    del inputs, queries, g

    # times at the serving shape: Q = 32, N = 100,000, euclidean, no ranks
    q, n = 32, SERVE_N
    inputs = _k1_inputs(n, q, "euclidean", gen)
    kw = dict(k=K, metric="euclidean", with_ranks=False)
    kernel_ms = time_ms(lambda: rf.fused_sweep_cuda(*inputs, **kw))
    plain_ms = time_ms(lambda: rf.fused_sweep_reference(*inputs, **kw))
    queries, g = inputs[0], inputs[3]
    library_ms = time_ms(lambda: torch.topk(torch.cdist(queries, g), K,
                                            largest=False))
    kernel_ms2 = time_ms(lambda: rf.fused_sweep_cuda(*inputs, **kw))
    # the norms around the sweep: the queries' on every search, the
    # gallery's once when the engine is built
    query_norms_ms = time_ms(lambda: rf.query_norms(queries, "euclidean"))
    gallery_norms_ms = time_ms(lambda: rf.gallery_norms(g, "euclidean"))
    bytes_moved = 4 * (n * D + q * D + n + 2 * q) + q * K * 8 + q * 8
    ops = 2 * q * n * D
    bound_ms = 1e3 * max(bytes_moved / H100_BYTES_PER_S,
                         ops / H100_F32_FLOP_PER_S)
    state["k1"] = {
        "name": "K1_fused_retrieval", "route": "cuda",
        "source": "art_sbir_tpu_torch/csrc/fused_retrieval.cu",
        "replaces": "art_sbir_tpu/ops/retrieval_pallas.py:365",
        "max_abs_err": max_err, "ms": min(kernel_ms, kernel_ms2),
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": ("bytes" if bytes_moved / H100_BYTES_PER_S
                     >= ops / H100_F32_FLOP_PER_S else "operations"),
        "library_ms": library_ms}
    del inputs, queries, g
    # K1 at other batch buckets of the main path, and at an offline-
    # evaluation batch (512, ranks on), beside each one's bound
    by_q = []
    for q, with_ranks in ((1, False), (4, False), (512, True)):
        inputs = _k1_inputs(n, q, "euclidean", gen)
        ms = time_ms(lambda: rf.fused_sweep_cuda(
            *inputs, k=K, metric="euclidean", with_ranks=with_ranks))
        q_bytes = 4 * (n * D + q * D + n + 2 * q) + q * K * 8 + q * 8
        by_q.append({"q": q, "with_ranks": with_ranks, "ms": ms,
                     "bound_ms": 1e3 * max(q_bytes / H100_BYTES_PER_S,
                                           2 * q * n * D
                                           / H100_F32_FLOP_PER_S)})
        del inputs
    emit({"phase": "kernels", "ok": True, "cases": len(cases) + 1,
          "case_rows": cases, "kernel_ms_runs": [kernel_ms, kernel_ms2],
          **{k: v for k, v in state["k1"].items() if k.endswith("ms")},
          "query_norms_ms": query_norms_ms,
          "gallery_norms_ms": gallery_norms_ms, "by_q": by_q})


# ---------------------------------------------------------------- encoder

def phase_encoder(state) -> None:
    import torch

    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.train.prepare import finish_gallery_batch

    ieee_f32()  # the float32 yardstick runs without TF32
    model = create_encoder(device="cuda", seed=0)  # full width, bf16
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(0, 256, (32, 224, 224, 3), generator=gen,
                      device="cuda", dtype=torch.uint8)

    def forward():
        with torch.no_grad():
            return model(finish_gallery_batch(x))

    out = forward()
    check(tuple(out.shape) == (32, 1024), "encoder output shape")
    check(bool(torch.isfinite(out).all()), "encoder outputs finite")
    ms = time_ms(forward, reps=10)
    model.compute_dtype = torch.float32
    ref = forward()
    f32_ms = time_ms(forward, reps=5)
    model.compute_dtype = torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(out, ref, dim=1)
    check(float(cos.min()) > 0.99, "bf16 vs float32 cosine > 0.99")
    emit({"phase": "encoder", "ok": True, "batch": 32, "image_size": 224,
          "dtype": "bfloat16", "ms_per_batch": ms,
          "images_per_s": 32e3 / ms, "f32_ms_per_batch": f32_ms,
          "cos_bf16_f32_min": float(cos.min()),
          "cos_bf16_f32_mean": float(cos.mean())})


# ------------------------------------------------------------------ serve

def _sketches(n: int, size: int = 224) -> np.ndarray:
    """``n`` synthetic line drawings: black strokes on white, uint8 RGB."""
    out = np.full((n, size, size, 3), 255, np.uint8)
    t = np.linspace(0.0, 1.0, 2 * size)[:, None]
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        for _ in range(3 + 3 * i):
            a, b = rng.integers(8, size - 8, (2, 2))
            pts = np.rint(a + t * (b - a)).astype(int)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    out[i, np.clip(pts[:, 0] + dy, 0, size - 1),
                        np.clip(pts[:, 1] + dx, 0, size - 1)] = 0
    return out


def _post(port: int, path: str, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def phase_serve(state) -> None:
    import base64
    import io
    import tempfile
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from art_sbir_tpu_torch.cli import serve
    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.ops import retrieval_fused as rf
    from art_sbir_tpu_torch.retrieval.embed import save_image_features
    from art_sbir_tpu_torch.train.prepare import finish_gallery_batch

    sketches = _sketches(8)
    rounds = 20  # closed loop: 8 clients, each sends again on its answer
    with tempfile.TemporaryDirectory() as tmp:
        # planted rows: the embeddings of the 8 sketches by the same seeded
        # fresh init that build_engine serves when no checkpoint exists
        enc = create_encoder(device="cuda", seed=0)
        with torch.no_grad():
            planted = enc(finish_gallery_batch(
                torch.from_numpy(sketches).cuda())).cpu().numpy()
        del enc
        rng = np.random.default_rng(0)
        feats = rng.standard_normal((SERVE_N, D), dtype=np.float32)
        feats = feats * planted.std() + planted.mean()
        slots = rng.choice(SERVE_N, 8, replace=False)
        feats[slots] = planted
        paths = [f"gallery/{i:06d}.jpg" for i in range(SERVE_N)]
        folder = save_image_features("ChipSmoke", "Random", paths, feats,
                                     root=tmp, timestamp="seed0")
        del feats
        args = serve.parse_args([
            "-f", "ModifiedResNet_ChipSmoke", "--features", folder,
            "--feature_root", tmp, "--results_root", tmp, "--models_root",
            tmp, "--device", "cuda", "--window_ms", "5"])
        t0 = time.perf_counter()
        engine, batcher = serve.build_engine(args)
        build_s = time.perf_counter() - t0
        check(engine.use_fused, "a 100,000-row gallery takes the K1 route")
        t0 = time.perf_counter()
        serve.warmup(engine, batcher)
        warmup_s = time.perf_counter() - t0
        thread_ms = _fresh_thread_dispatch_ms(engine, sketches[:1])
        dispatches = []  # (batch, seconds) of each engine dispatch
        search_arrays = engine.search_arrays

        def timed_search_arrays(images):
            t = time.perf_counter()
            out = search_arrays(images)
            dispatches.append((len(images), time.perf_counter() - t))
            return out

        engine.search_arrays = timed_search_arrays
        httpd = serve.Server(("127.0.0.1", 0),
                             serve.make_handler(engine, batcher))
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        port = httpd.server_address[1]
        lat, tops, round_s = [], [], []
        try:
            rf.counters.reset()  # the main path's run starts here
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
                health = json.loads(r.read())
            check(health["gallery_size"] == SERVE_N, "/healthz gallery size")
            if state.get("pil", True):
                from PIL import Image

                def png(a):
                    buf = io.BytesIO()
                    Image.fromarray(a).save(buf, "PNG")
                    return base64.b64encode(buf.getvalue()).decode()

                b64 = [png(s) for s in sketches]

                def one(i):
                    t = time.perf_counter()
                    out = _post(port, "/search", {"image_b64": b64[i]})
                    return time.perf_counter() - t, out["paths"][0]

                t_all = time.perf_counter()
                with ThreadPoolExecutor(8) as pool:
                    for _ in range(rounds):
                        t_round = time.perf_counter()
                        res = list(pool.map(one, range(8)))
                        round_s.append(time.perf_counter() - t_round)
                        lat += [r[0] for r in res]
                        tops += [r[1] for r in res]
                wall = time.perf_counter() - t_all
                n_timed = len(dispatches)
                t = time.perf_counter()
                batch = _post(port, "/search_batch", {"images_b64": b64})
                search_batch_ms = 1e3 * (time.perf_counter() - t)
                tops += [r["paths"][0] for r in batch["results"]]
                transport = "http"
            else:  # no PIL on this machine: the engine, from 8 threads
                def one(i):
                    t = time.perf_counter()
                    _, idx = engine.search_arrays(sketches[i:i + 1])
                    return time.perf_counter() - t, paths[int(idx[0, 0])]

                t_all = time.perf_counter()
                with ThreadPoolExecutor(8) as pool:
                    for _ in range(rounds):
                        t_round = time.perf_counter()
                        res = list(pool.map(one, range(8)))
                        round_s.append(time.perf_counter() - t_round)
                        lat += [r[0] for r in res]
                        tops += [r[1] for r in res]
                wall = time.perf_counter() - t_all
                n_timed = len(dispatches)
                t = time.perf_counter()
                _, idx = engine.search_arrays(sketches)
                search_batch_ms = 1e3 * (time.perf_counter() - t)
                tops += [paths[int(i)] for i in idx[:, 0]]
                transport = "search_arrays from 8 threads (no PIL)"
            torch.cuda.synchronize()
            launches = rf.counters.launches
            fallback = rf.counters.fallback_rows
            engine.search_arrays = search_arrays
            profile = _profile_dispatch(engine, sketches)
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.close()
            server.join(timeout=10)
    want = [paths[s] for s in slots] * (rounds + 1)
    check(tops == want, "each top-1 is its planted row")
    check(launches > 0, "K1 launched on the main path")
    check(fallback == 0, "K1 never fell back")
    state["serve_launches"] = launches
    n_req = 8 * rounds
    timed = dispatches[:n_timed]
    dispatch_ms = [1e3 * t for _, t in timed]
    emit({"phase": "serve", "ok": True, "transport": transport,
          "gallery": SERVE_N, "dim": D, "route": "K1", "clients": 8,
          "requests": n_req, "failed": 0, "qps": n_req / wall,
          "p50_ms": 1e3 * float(np.median(lat)),
          "p90_ms": 1e3 * float(np.percentile(lat, 90)),
          "max_ms": 1e3 * max(lat),
          "mean_batch": float(np.mean([b for b, _ in timed])),
          "batches": len(timed), "k1_launches": launches,
          "fallback_rows": fallback,
          "round_ms_first5": [1e3 * r for r in round_s[:5]],
          "round_ms_max": 1e3 * max(round_s),
          "dispatch_ms_p50": float(np.median(dispatch_ms)),
          "dispatch_ms_max": max(dispatch_ms),
          "dispatch_share_of_wall": sum(t for _, t in timed) / wall,
          "search_batch_of_8_ms": search_batch_ms,
          "fresh_thread_dispatch_ms": thread_ms,
          "build_engine_s": build_s, "warmup_s": warmup_s})
    emit({"phase": "serve_profile", **profile})


def _fresh_thread_dispatch_ms(engine, images) -> list:
    """Two dispatches on each of two threads started one after the other
    (an HTTP handler thread is new for every connection): the first use
    of the CUDA libraries on a thread shows as a slow first dispatch."""
    import threading

    import torch

    out = []

    def run():
        for _ in range(2):
            t = time.perf_counter()
            engine.search_arrays(images)
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t))

    for _ in range(2):
        th = threading.Thread(target=run)
        th.start()
        th.join(timeout=120)
        check(not th.is_alive(), "dispatch on a fresh thread finished")
    return out


def _profile_dispatch(engine, sketches, reps: int = 3) -> dict:
    """Where one coalesced dispatch of 8 queries spends its time: wall
    clock, summed device kernel time by name (torch.profiler), and the
    share of the wall clock with the device idle. Runs after the counted
    main path; its K1 launches are not counted there."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.search_arrays(sketches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.search_arrays(sketches)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    kernels = {}  # device-side events only: kernels and copies
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            kernels[ev.key] = (kernels.get(ev.key, 0.0)
                               + ev.self_device_time_total / 1e3 / reps)
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    k1_ms = sum(v for k, v in kernels.items() if "k1_" in k)
    return {"batch": len(sketches), "wall_ms": 1e3 * wall,
            "device_ms": device_ms, "k1_device_ms": k1_ms,
            "device_idle_share": max(0.0, 1 - device_ms / (1e3 * wall)),
            "kernels_seen": len(kernels),
            "top_device_ms": [[k[:60], v] for k, v in top]}


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    import art_sbir_tpu_torch  # noqa: F401  (fails outside a checkout)

    state = {}
    for phase in (phase_build, phase_kernels, phase_encoder, phase_serve):
        phase(state)
    emit({"kernels": [{**state["k1"], "launches": state["serve_launches"]}]})
    print(state["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
