"""IVF-PQ on the card: quality and speed at 600k rows, and the streamed
3M-row build.

Counterpart of the JAX package's ``scripts/probe_pq.py``.

Part A (``--part a``): a clustered 600k x 1024 gallery resident on the
card. At the serving regime (B in {1, 8, 32}, dispatch to host pull, the
best of interleaved rounds) it times the IVF exact-scored probe, IVF-PQ
with the exact rerank on bf16 rows, and pure IVF-PQ (rows dropped), at
nprobe 8; it reports recall@10 against the exact route for raw and
residual codebooks, and for the residual one at rerank budgets 160, 640
and 2,560.

Part B (``--part b``): the build PQ exists for, a gallery that is never
resident in float32. Rows are made on the card chunk by chunk from a
seeded generator, each chunk is IVF-assigned and PQ-encoded against
residual codebooks fitted on chunk 0, and only the uint8 codes (3M x 64 =
192 MB), the cluster table and the centroids stay. The exact reference
for recall streams the same chunks through an exact scan. Resident bytes
and dispatch latency are the readings. On the JAX package's TPU v5e (16
GB) 3M x 1024 float32 rows (12.3 GB) did not fit beside the build; on the
card's 80 GB they would, so at JAX's sizes part B shows the streamed
build, not a necessity. ``--big_n`` takes it past the card (about 19M
rows).

    python -m art_sbir_tpu_torch.scripts.probe_pq [--part a|b|both]
        [--n 600000] [--big_n 3000000] [--d 1024] [--m 64] [--opq 0]
        [--rounds 6] [--device cuda|cpu]

``--device cpu`` runs on the CPU and times on the host clock: those
times say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import time
import numpy as np
import torch

from art_sbir_tpu_torch.core.device import (card_fields, ieee_f32,
                                            resolve_device)
from art_sbir_tpu_torch.ops.distance import retrieve_chunked
from art_sbir_tpu_torch.ops.ivf import (IVFIndex, _assign, _generator,
                                        build_ivf, ivf_search, kmeans,
                                        pack_table)
from art_sbir_tpu_torch.ops.pq import (PQCodebook, build_ivf_pq, encode_pq,
                                       ivf_pq_search, train_pq)
from art_sbir_tpu_torch.ops.quant import topk_overlap
from art_sbir_tpu_torch.scripts.probe_util import (best_ms, blob_centres,
                                                   blob_rows, log,
                                                   make_gallery)

K = 10
NPROBE = 8
BATCHES = (1, 8, 32)  # part A's queries a dispatch
CHUNK = 131_072  # part B's rows made, assigned and encoded at a time
B_QUERIES = 8  # part B's queries


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def part_a(n: int = 600_000, d: int = 1024, m: int = 64, opq: int = 0,
           rounds: int = 6, device="cuda") -> dict:
    dev = resolve_device(device)
    ieee_f32()
    g = make_gallery(n, d, True, dev)
    out = {"n": n, "m": m}

    t0 = time.perf_counter()
    index = build_ivf(g, None)
    _sync(dev)
    out["ivf_build_s"] = time.perf_counter() - t0
    out["stats"] = index.stats()
    log(f"A: IVF build {out['ivf_build_s']:.1f}s {out['stats']}")
    t0 = time.perf_counter()
    raw_cb = train_pq(g, m)
    raw_codes = encode_pq(g, raw_cb)
    _sync(dev)
    out["raw_pq_s"] = time.perf_counter() - t0
    log(f"A: raw PQ train+encode {out['raw_pq_s']:.1f}s (m={m}, {m} B/row)")
    t0 = time.perf_counter()
    cb, codes = build_ivf_pq(g, index, m, opq_iters=opq)
    _sync(dev)
    out["residual_pq_s"] = time.perf_counter() - t0
    log(f"A: residual IVF-PQ build {out['residual_pq_s']:.1f}s"
        f"{f' (opq_iters={opq})' if opq else ''}")
    gb16 = g.to(torch.bfloat16)

    b_max = max(BATCHES)
    q = g[:b_max] + 0.1 * torch.randn((b_max, d),
                                      generator=_generator(23, dev),
                                      device=dev)
    _, _, exact = retrieve_chunked(
        q, g, torch.zeros(b_max, dtype=torch.int32, device=dev), k=K,
        chunk=b_max)
    exact = exact.cpu().numpy()

    recall = {}
    for tag, c_cb, c_codes, rows in (
            ("ivf exact-scored", None, None, None),
            ("raw-pq rerank-bf16", raw_cb, raw_codes, gb16),
            ("raw-pq pure", raw_cb, raw_codes, None),
            ("res-pq rerank-bf16", cb, codes, gb16),
            ("res-pq pure", cb, codes, None)):
        if c_cb is None:
            _, ids = ivf_search(q, index, g, nprobe=NPROBE, k=K)
        else:
            _, ids = ivf_pq_search(q, index, c_codes, c_cb, nprobe=NPROBE,
                                   k=K, rows=rows)
        recall[tag] = topk_overlap(ids, exact)
        log(f"A: recall@10 {tag}: {recall[tag]:.4f}")
    # the rerank budget is the quality lever: the exact re-score is
    # O(Q * r * D) on gathered rows, while the ADC only has to land the
    # true top-k among its top r
    for rf in (16, 64, 256):
        _, ids = ivf_pq_search(q, index, codes, cb, nprobe=NPROBE, k=K,
                               rows=gb16, rerank_factor=rf)
        tag = f"res-pq rerank r={rf * K}"
        recall[tag] = topk_overlap(ids, exact)
        log(f"A: recall@10 {tag}: {recall[tag]:.4f}")
    out["recall_at_10"] = recall

    def pull(res):
        return tuple(t.cpu().numpy() for t in res)

    times = {}
    for b in BATCHES:
        qb = q[:b]
        routes = [
            ("ivf exact", lambda: pull(ivf_search(qb, index, g,
                                                  nprobe=NPROBE, k=K))),
            ("pq+rerank", lambda: pull(ivf_pq_search(
                qb, index, codes, cb, nprobe=NPROBE, k=K, rows=gb16))),
            ("pq pure", lambda: pull(ivf_pq_search(
                qb, index, codes, cb, nprobe=NPROBE, k=K)))]
        best = best_ms(routes, rounds, dev)
        for tag, _ in routes:
            log(f"A: B={b:>2} {tag:<10} {best[tag]:8.3f} ms/dispatch")
        times[str(b)] = best
    out["ms_per_dispatch"] = times
    return out


def part_b(big_n: int = 3_000_000, d: int = 1024, m: int = 64,
           rounds: int = 6, device="cuda") -> dict:
    dev = resolve_device(device)
    ieee_f32()
    n, n_queries = big_n, B_QUERIES
    chunk = min(CHUNK, n)
    n_chunks = -(-n // chunk)
    nb = max(4, int(np.sqrt(n)))
    centres = blob_centres(_generator(41, dev), nb, d, dev)

    def chunk_rows(i: int, rows: int) -> torch.Tensor:
        return blob_rows(_generator(42_000 + i, dev), rows, centres)

    # IVF centroids and RESIDUAL codebooks fitted on chunk 0 (a seeded
    # sample): the streamed form of ops/pq.py::build_ivf_pq, since the
    # gallery never exists whole
    t0 = time.perf_counter()
    sample = chunk_rows(0, chunk)
    nlist = max(1, int(2 * np.sqrt(n)))
    cent = kmeans(sample, nlist, iters=10)
    s_labels = _assign(sample, cent, chunk=chunk).long()
    base = train_pq(sample - cent[s_labels], m, metric="euclidean")
    cb = PQCodebook(base.centroids, "euclidean", True)
    del sample, s_labels
    codes_np = np.empty((n, m), np.uint8)
    labels_np = np.empty(n, np.int32)
    done = 0
    for i in range(n_chunks):
        rows = min(chunk, n - done)
        ch = chunk_rows(i, rows)
        lab = _assign(ch, cent, chunk=rows).long()
        codes_np[done:done + rows] = encode_pq(ch - cent[lab],
                                               cb).cpu().numpy()
        labels_np[done:done + rows] = lab.cpu().numpy()
        done += rows
        del ch, lab
        if (i + 1) % 10 == 0 or i + 1 == n_chunks:
            log(f"B: encoded {done:,}/{n:,} rows "
                f"({time.perf_counter() - t0:.0f}s)")
    table, counts = pack_table(labels_np, nlist, n)
    index = IVFIndex(cent, torch.as_tensor(table, device=dev), counts,
                     "euclidean")
    codes = torch.as_tensor(codes_np, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    cent_bytes = cent.numel() * cent.element_size()
    resident = codes_np.nbytes + table.nbytes + cent_bytes
    out = {"n": n, "m": m, "chunk": chunk, "build_s": build_s,
           "resident_bytes": int(resident),
           "codes_bytes": int(codes_np.nbytes),
           "table_bytes": int(table.nbytes), "centroid_bytes": int(cent_bytes),
           "float32_gallery_bytes": n * d * 4, "stats": index.stats()}
    log(f"B: streamed build {build_s:.1f}s, {n:,} rows, resident "
        f"{resident / 1e6:.0f} MB (codes {codes_np.nbytes / 1e6:.0f} + table "
        f"{table.nbytes / 1e6:.0f} + centroids {cent_bytes / 1e6:.0f}); a "
        f"float32 gallery would be {n * d * 4 / 1e9:.1f} GB")
    log(f"B: {out['stats']}")

    # queries near known rows of a mid-stream chunk
    at = min(3, n_chunks - 1)
    near = chunk_rows(at, min(chunk, n - at * chunk))[:n_queries]
    q = near + 0.1 * torch.randn((n_queries, d), generator=_generator(7, dev),
                                 device=dev)
    del near

    # the exact reference: the same chunks through an exact scan
    t0 = time.perf_counter()
    best_v = np.full((n_queries, K), np.inf, np.float32)
    best_i = np.full((n_queries, K), -1, np.int64)
    done = 0
    zeros = torch.zeros(n_queries, dtype=torch.int32, device=dev)
    for i in range(n_chunks):
        rows = min(chunk, n - done)
        ch = chunk_rows(i, rows)
        _, v, idx = retrieve_chunked(q, ch, zeros, k=K, chunk=n_queries)
        allv = np.concatenate([best_v, v.cpu().numpy()], axis=1)
        alli = np.concatenate([best_i, idx.cpu().numpy() + done], axis=1)
        order = np.argsort(allv, axis=1, kind="stable")[:, :K]
        best_v = np.take_along_axis(allv, order, axis=1)
        best_i = np.take_along_axis(alli, order, axis=1)
        done += rows
        del ch
    out["exact_reference_s"] = time.perf_counter() - t0
    log(f"B: streamed exact reference {out['exact_reference_s']:.1f}s")

    out["pure_pq_recall"] = {}
    for nprobe in (4, 8, 16):
        _, ids = ivf_pq_search(q, index, codes, cb, nprobe=nprobe, k=K)
        r10 = topk_overlap(ids, best_i)
        r1 = float(np.mean(ids.cpu().numpy()[:, 0] == best_i[:, 0]))
        out["pure_pq_recall"][str(nprobe)] = {"at1": r1, "at10": r10}
        log(f"B: pure-PQ recall nprobe={nprobe:>2}: @1 {r1:.4f} "
            f"@10 {r10:.4f}")

    def dispatch():
        return tuple(t.cpu().numpy() for t in ivf_pq_search(
            q, index, codes, cb, nprobe=NPROBE, k=K))

    out["pure_pq_ms_per_dispatch"] = best_ms([("pq", dispatch)], rounds,
                                             dev)["pq"]
    log(f"B: pure-PQ dispatch (B={n_queries}, nprobe={NPROBE}, {n:,} rows): "
        f"{out['pure_pq_ms_per_dispatch']:.3f} ms")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--part", default="both", choices=["a", "b", "both"])
    p.add_argument("--n", type=int, default=600_000, help="part-A rows")
    p.add_argument("--big_n", type=int, default=3_000_000,
                   help="part-B rows")
    p.add_argument("--d", type=int, default=1024)
    p.add_argument("--m", type=int, default=64, help="PQ codes a row")
    p.add_argument("--opq", type=int, default=0,
                   help="OPQ iterations for the residual build (part A)")
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    res = {"device": str(dev), **card_fields(dev),
           "clock": "CUDA events" if dev.type == "cuda" else "host"}
    if args.part in ("a", "both"):
        res["a"] = part_a(args.n, args.d, args.m, args.opq, args.rounds, dev)
    if args.part in ("b", "both"):
        res["b"] = part_b(args.big_n, args.d, args.m, args.rounds, dev)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
