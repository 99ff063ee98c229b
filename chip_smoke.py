"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build       -- compile K1 (csrc/fused_retrieval.cu) and K2
                  (csrc/quant_candidates.cu) with nvcc, both at once; the
                  card's name and power limit from nvidia-smi.
2. kernels     -- K1 against its plain PyTorch version on the card
                  (D = 1024, k = 10, N in {100000, 100003}, Q in {1, 32,
                  512}, both metrics, ranks on and off, a case with
                  duplicated gallery rows), and K1's times at the serving
                  shape.
3. kernels_k2  -- K2 against its plain version on the card, scores and
                  indices bit-identical (D = 1024, N in {1000000,
                  1000003}, Q in {1, 32, 512}, both metrics, r in {40,
                  128}, and duplicated gallery rows that straddle the r-th
                  candidate), K2 and the exact rerank on float32 and bf16
                  rows against the plain int8 route, K2's times at the
                  serving shape, and the engine's two int8 routes (K2's
                  and the plain scan's) timed at 10,000 to 1,000,000 rows.
4. encoder     -- the full-width ModifiedResNet50 forward, bf16, batch 32
                  at 224 px: finite outputs, cosine similarity to float32
                  (TF32 off), images/s.
5. serve       -- the serving path at full width: a 100,000 x 1024 feature
                  cache with 8 planted rows, ``cli/serve.py::build_engine``
                  on the card, warmup, then /healthz, 20 rounds of 8
                  concurrent /search and one /search_batch of 8 over HTTP
                  (then one dispatch under torch.profiler, outside the
                  counted run). Each top-1 must be its planted row; K1 must
                  have been launched and never fallen back.
6. serve_quant -- the same with ``--quantize`` over a 1,000,000 x 1024
                  cache (500,000 rows only where the temporary directory
                  cannot hold the larger one): the
                  engine must take the K2 route, K2 must have been launched
                  and never fallen back.

Every kernel count is set to 0 just before each serve phase's requests and
read just after them; the launch counts in the kernels line come from
those runs alone. Any failed check exits non-zero. The last line is
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
H100_INT8_OP_PER_S = 1979e12  # int8 tensor cores, dense
D, K = 1024, 10
SERVE_N = 100_000
QUANT_N = 1_000_000  # the int8 route's serving gallery
R = 40  # K2's candidates at the serving engine's k_max 10, rerank_factor 4


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
    from concurrent.futures import ThreadPoolExecutor

    from art_sbir_tpu_torch.ops import quant_fused as qf
    from art_sbir_tpu_torch.ops import retrieval_fused as rf

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        libs = list(pool.map(lambda m: m.KERNEL.build(), (rf, qf)))
    secs = time.perf_counter() - t0
    ptxas = {lib.name: [ln.strip() for ln in lib.with_suffix(".log")
                        .read_text().splitlines()
                        if "registers" in ln or "spill" in ln]
             for lib in libs}
    import importlib.util

    import torch

    state["card"] = card_line()
    state["pil"] = importlib.util.find_spec("PIL") is not None
    emit({"phase": "build", "ok": True, "nvcc_s": secs,
          "libraries": [lib.name for lib in libs], "ptxas": ptxas,
          "card": state["card"], "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "pil": state["pil"]})


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


def _k2_inputs(g, q, metric, gen, near=None):
    """Quantized gallery and queries for K2: random queries, or queries
    within 0.01 of gallery row ``near``."""
    import torch

    from art_sbir_tpu_torch.ops import quant

    qg = quant.quantize_gallery(g, metric)
    x = torch.randn((q, D), generator=gen, device="cuda")
    if near is not None:
        x = g[near] + 0.01 * x
    q8, s_q = quant._quantize_queries(x, metric)
    return q8, s_q, qg.q8, qg.scale, qg.sq_norm


def _k2_compare(inputs, r, metric, what):
    import torch

    from art_sbir_tpu_torch.ops import quant_fused as qf

    out = qf.quant_candidates_cuda(*inputs, r=r, metric=metric)
    ref = qf.quant_candidates_reference(*inputs, r=r, metric=metric)
    torch.cuda.synchronize()
    check(bool(out[2].all()), f"K2 certificate ({what})")
    check(torch.equal(out[1], ref[1]), f"K2 indices bit-identical ({what})")
    check(torch.equal(out[0], ref[0]), f"K2 scores bit-identical ({what})")
    return out, float((out[0] - ref[0]).abs().max())


def phase_kernels_k2(state) -> None:
    import torch

    from art_sbir_tpu_torch.ops import quant
    from art_sbir_tpu_torch.ops import quant_fused as qf

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases, max_err = [], 0.0
    for n in (QUANT_N, QUANT_N + 3):
        g = torch.randn((n, D), generator=gen, device="cuda")
        for metric in ("euclidean", "cosine"):
            for q in (1, 32, 512):
                inputs = _k2_inputs(g, q, metric, gen)
                for r in (R, 128):
                    _, err = _k2_compare(inputs, r, metric,
                                         f"{n} {metric} {q} {r}")
                    max_err = max(max_err, err)
                    cases.append([n, q, metric, r])
                del inputs
        del g
    # duplicated rows: 64 equal copies of one row, spread over the gallery,
    # are the queries' 64 best rows with equal scores; the r-th candidate
    # falls among them, and the earlier indices must win
    g = torch.randn((QUANT_N, D), generator=gen, device="cuda")
    copies = torch.arange(64, device="cuda") * (QUANT_N // 64) + 7
    g[copies] = g[7].clone()
    for metric in ("euclidean", "cosine"):
        inputs = _k2_inputs(g, 32, metric, gen, near=7)
        for r in (R, 128):
            out, err = _k2_compare(inputs, r, metric, f"ties {metric} {r}")
            max_err = max(max_err, err)
            want = copies[:min(r, 64)].to(torch.int32)
            check(bool((out[1][:, :min(r, 64)] == want).all()),
                  "K2 ties: the copies in index order, earlier first")
            check(bool((out[0][:, :min(r, 64)] == out[0][:, :1]).all()),
                  "K2 ties: the copies' scores are equal")
            cases.append(["ties", 32, metric, r])
        del inputs
    del g

    # the route around K2 on the card: queries near 32 gallery rows, K2 and
    # the exact rerank on float32 and on bf16 rows, against the plain route
    q, n = 32, QUANT_N
    g = torch.randn((n, D), generator=gen, device="cuda")
    rows = torch.randint(0, n, (q,), generator=gen, device="cuda")
    x = g[rows] + 0.05 * torch.randn((q, D), generator=gen, device="cuda")
    for metric in ("euclidean", "cosine"):
        qg = quant.quantize_gallery(g, metric)
        v0, i0 = quant.retrieve_quantized(x, qg, g, k=K, rerank_factor=4)
        for rows_dtype in (torch.float32, torch.bfloat16):
            v1, i1 = quant.retrieve_quantized_fused(
                x, qg, g.to(rows_dtype), k=K, rerank_factor=4,
                device_get=True)
            check(bool((i1[:, 0] == rows.cpu().numpy()).all()),
                  f"int8 route top-1 ({metric}, {rows_dtype})")
            if rows_dtype == torch.float32:
                check(np.array_equal(i1, i0.cpu().numpy())
                      and np.array_equal(v1, v0.cpu().numpy()),
                      f"K2 route equals the plain int8 route ({metric})")
        del qg
    cases.append(["route", q, "both", R])

    # times at the serving shape: Q = 32, N = 1,000,000, r = 40, euclidean
    inputs = _k2_inputs(g, q, "euclidean", gen)
    q8, s_q, g8, g_scale, g_sq = inputs
    kw = dict(r=R, metric="euclidean")
    kernel_ms = time_ms(lambda: qf.quant_candidates_cuda(*inputs, **kw))
    plain_ms = time_ms(lambda: qf.quant_candidates_reference(*inputs, **kw))

    def library():  # int8 product, the score, then top-k
        cross = torch._int_mm(q8, g8.t())
        dot = cross.float() * (s_q[:, None] * g_scale[None, :])
        return torch.topk(g_sq[None, :] - 2.0 * dot, R, largest=False)

    library_ms = time_ms(library)
    kernel_ms2 = time_ms(lambda: qf.quant_candidates_cuda(*inputs, **kw))
    quantize_ms = time_ms(lambda: quant.quantize_gallery(g, "euclidean"),
                          reps=3, warmup=1)

    def bound(q, r):
        nbytes = q * D + 4 * q + n * D + 8 * n + 8 * q * r + 4 * q
        ops = 2 * q * n * D
        return (1e3 * max(nbytes / H100_BYTES_PER_S, ops / H100_INT8_OP_PER_S),
                "bytes" if nbytes / H100_BYTES_PER_S
                >= ops / H100_INT8_OP_PER_S else "operations")

    bound_ms, bound_by = bound(q, R)
    state["k2"] = {
        "name": "K2_quant_candidates", "route": "cuda",
        "source": "art_sbir_tpu_torch/csrc/quant_candidates.cu",
        "replaces": "art_sbir_tpu/ops/retrieval_pallas.py:704",
        "max_abs_err": max_err, "ms": min(kernel_ms, kernel_ms2),
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}
    del inputs, q8, g8
    # K2 at other batch buckets and candidate budgets, beside each bound
    by_q = []
    for q, r in ((1, R), (8, R), (32, 128), (512, R)):
        inputs = _k2_inputs(g, q, "euclidean", gen)
        ms = time_ms(lambda: qf.quant_candidates_cuda(
            *inputs, r=r, metric="euclidean"))
        by_q.append({"q": q, "r": r, "ms": ms, "bound_ms": bound(q, r)[0]})
        del inputs
    del g
    # the engine's two int8 routes as a dispatch runs them (query
    # quantization, candidates, exact rerank, results to the host): K2's
    # and the plain scan's, at galleries from 10,000 rows up
    by_n = []
    for n in (10_000, 50_000, 100_000, 250_000, QUANT_N):
        g = torch.randn((n, D), generator=gen, device="cuda")
        qg = quant.quantize_gallery(g, "euclidean")
        for q in (1, 32):
            x = torch.randn((q, D), generator=gen, device="cuda")

            def k2_route():
                return quant.retrieve_quantized_fused(
                    x, qg, g, k=K, rerank_factor=4, device_get=True)

            def plain_route():
                return [t.cpu().numpy() for t in quant.retrieve_quantized(
                    x, qg, g, k=K, rerank_factor=4)]

            a, b = k2_route(), plain_route()
            check(np.array_equal(a[1], b[1]) and np.array_equal(a[0], b[0]),
                  f"K2 route equals the plain int8 route ({n} rows, Q={q})")
            by_n.append({"n": n, "q": q, "k2_route_ms": time_ms(k2_route),
                         "plain_route_ms": time_ms(plain_route)})
        del g, qg
    emit({"phase": "kernels_k2", "ok": True, "cases": len(cases),
          "case_rows": cases, "kernel_ms_runs": [kernel_ms, kernel_ms2],
          **{k: v for k, v in state["k2"].items() if k.endswith("ms")},
          "bound_by": bound_by, "quantize_gallery_ms": quantize_ms,
          "by_q": by_q, "routes_by_n": by_n})


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


def _counters():
    """The launch counters of every kernel, by the route that runs it."""
    from art_sbir_tpu_torch.ops import quant_fused as qf
    from art_sbir_tpu_torch.ops import retrieval_fused as rf

    return {"K1": rf.counters, "K2": qf.counters}


def _gallery_features(n: int, planted: np.ndarray, seed: int):
    """(n, D) float32 rows with the planted rows' mean and spread, and the
    planted rows at ``slots``. Rows past 100,000 are drawn on the card."""
    import torch

    rng = np.random.default_rng(seed)
    if n <= SERVE_N:
        feats = rng.standard_normal((n, D), dtype=np.float32)
        feats = feats * planted.std() + planted.mean()
    else:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        feats = torch.randn((n, D), generator=gen, device="cuda")
        feats = (feats * float(planted.std())
                 + float(planted.mean())).cpu().numpy()
    slots = rng.choice(n, 8, replace=False)
    feats[slots] = planted
    return feats, slots


def phase_serve(state) -> None:
    _serve(state, "serve", SERVE_N, route="K1", flags=[])


def phase_serve_quant(state) -> None:
    import shutil
    import tempfile

    # the float32 cache of QUANT_N rows is 4.2 GB on disk; where the
    # temporary directory cannot hold it twice over, serve half as many
    need = 2 * 4 * QUANT_N * D
    n = (QUANT_N if shutil.disk_usage(tempfile.gettempdir()).free >= need
         else QUANT_N // 2)
    _serve(state, "serve_quant", n, route="K2", flags=["--quantize"])


def _serve(state, phase: str, n_rows: int, route: str, flags: list) -> None:
    import base64
    import io
    import tempfile
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from art_sbir_tpu_torch.cli import serve
    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.retrieval.embed import save_image_features
    from art_sbir_tpu_torch.train.prepare import finish_gallery_batch

    sketches = _sketches(8)
    rounds = 20  # closed loop: 8 clients, each sends again on its answer
    counters = _counters()
    with tempfile.TemporaryDirectory() as tmp:
        # planted rows: the embeddings of the 8 sketches by the same seeded
        # fresh init that build_engine serves when no checkpoint exists
        enc = create_encoder(device="cuda", seed=0)
        with torch.no_grad():
            planted = enc(finish_gallery_batch(
                torch.from_numpy(sketches).cuda())).cpu().numpy()
        del enc
        feats, slots = _gallery_features(n_rows, planted, seed=0)
        paths = [f"gallery/{i:07d}.jpg" for i in range(n_rows)]
        t0 = time.perf_counter()
        folder = save_image_features("ChipSmoke", "Random", paths, feats,
                                     root=tmp, timestamp="seed0")
        save_s = time.perf_counter() - t0
        del feats
        args = serve.parse_args([
            "-f", "ModifiedResNet_ChipSmoke", "--features", folder,
            "--feature_root", tmp, "--results_root", tmp, "--models_root",
            tmp, "--device", "cuda", "--window_ms", "5", *flags])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine, batcher = serve.build_engine(args)
        build_s = time.perf_counter() - t0
        check(engine.route == route,
              f"a {n_rows}-row gallery with {flags} takes the {route} route")
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
            for c in counters.values():  # this path's run starts here
                c.reset()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
                health = json.loads(r.read())
            check(health["gallery_size"] == n_rows, "/healthz gallery size")
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
            launches = {name: c.launches for name, c in counters.items()}
            fallback = counters[route].fallback_rows
            engine.search_arrays = search_arrays
            profile = _profile_dispatch(engine, sketches,
                                        prefix=route.lower() + "_")
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.close()
            server.join(timeout=10)
    want = [paths[s] for s in slots] * (rounds + 1)
    check(tops == want, "each top-1 is its planted row")
    check(launches[route] > 0, f"{route} launched on the main path")
    check(all(v == 0 for name, v in launches.items() if name != route),
          f"no other kernel than {route} launched on this path")
    check(fallback == 0, f"{route} never fell back")
    state["launches"][route] = launches[route]
    n_req = 8 * rounds
    timed = dispatches[:n_timed]
    dispatch_ms = [1e3 * t for _, t in timed]
    emit({"phase": phase, "ok": True, "transport": transport,
          "gallery": n_rows, "dim": D, "route": route, "clients": 8,
          "requests": n_req, "failed": 0, "qps": n_req / wall,
          "p50_ms": 1e3 * float(np.median(lat)),
          "p90_ms": 1e3 * float(np.percentile(lat, 90)),
          "max_ms": 1e3 * max(lat),
          "mean_batch": float(np.mean([b for b, _ in timed])),
          "batches": len(timed), "launches": launches,
          "fallback_rows": fallback,
          "round_ms_first5": [1e3 * r for r in round_s[:5]],
          "round_ms_max": 1e3 * max(round_s),
          "dispatch_ms_p50": float(np.median(dispatch_ms)),
          "dispatch_ms_max": max(dispatch_ms),
          "dispatch_share_of_wall": sum(t for _, t in timed) / wall,
          "search_batch_of_8_ms": search_batch_ms,
          "fresh_thread_dispatch_ms": thread_ms,
          "save_cache_s": save_s, "build_engine_s": build_s,
          "warmup_s": warmup_s,
          "peak_gpu_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    emit({"phase": phase + "_profile", **profile})


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


def _profile_dispatch(engine, sketches, prefix: str, reps: int = 3) -> dict:
    """Where one coalesced dispatch of 8 queries spends its time: wall
    clock, summed device kernel time by name (torch.profiler), the time of
    the route's kernel (names starting ``prefix``), and the share of the
    wall clock with the device idle. Runs after the counted main path; its
    launches are not counted there."""
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
    kernel_ms = sum(v for k, v in kernels.items() if prefix in k)
    return {"batch": len(sketches), "wall_ms": 1e3 * wall,
            "device_ms": device_ms, f"{prefix}device_ms": kernel_ms,
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

    state = {"launches": {}}
    for phase in (phase_build, phase_kernels, phase_kernels_k2,
                  phase_encoder, phase_serve, phase_serve_quant):
        phase(state)
    emit({"kernels": [{**state[name.lower()],
                       "launches": state["launches"][name]}
                      for name in ("K1", "K2")]})
    print(state["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
