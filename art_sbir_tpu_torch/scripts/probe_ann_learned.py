"""The ANN tiers measured on a trained encoder's embeddings.

Counterpart of the JAX package's ``scripts/probe_ann_learned.py``. The
serving tiers' quality contracts (int8 overlap, the IVF nprobe sweep,
IVF-PQ rerank budgets, ``tune_nprobe``'s perturbed-row proxy) were first
measured on synthetic geometry; this probe measures them on the
distribution a trained model emits, at a gallery of 50,735 rows, with
real cross-modal queries:

1. **Train** the flagship recipe (ModifiedResNet_with_classification,
   the triplet loss, lr 1e-4 from scratch, 10 epochs at 128 px) on the
   learnable corpus through ``cli/train.main``: the ``learn`` golden's
   recipe. ``--skip_train RUN`` takes the export ``models/RUN.pt``.
2. **Gallery**: the corpus's 735 test photos (their sketches' positives)
   and 50,000 distractors from 250 unseen classes of the learnable
   generator, rendered in memory by ``data/synthetic._learnable_photo``.
3. **Queries**: the corpus's 1,000 test sketches through the same
   encoder.
4. **Exact scan**: each sketch's positive's rank in the whole gallery
   (MRR, recall@1/10, against the chance ``(ln N + gamma) / N``) and the
   exact top-10, the truth for the tiers.
5. **Tiers**: int8 top-10 overlap at rerank budgets 40 and 80, IVF
   recall@10 at nprobe 1 to 32, ``tune_nprobe`` on the engine's proxy
   (256 gallery rows plus 0.05 std noise) against the real queries with
   the engine's margin, residual IVF-PQ pure and at rerank budgets 40,
   160 and 640, and with OPQ.

Writes ``goldens/torch_ann_learned_<cpu|cuda>.json`` whole (a rerun
leaves no key of an older file), with the card's name and power limit on
the card; the run folder goes under ``--results_root results_ann_torch``
and the corpus under ``--root data/ann_learned_torch``. Each stage is a
function of its sizes, so the tests run it end to end at a tiny size.

    python -m art_sbir_tpu_torch.scripts.probe_ann_learned
        [--root data/ann_learned_torch] [--results_root results_ann_torch]
        [--seed 0] [--skip_train RUN] [--out PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from art_sbir_tpu_torch.cli.goldens import chance_mrr
from art_sbir_tpu_torch.core.device import (card_fields, ieee_f32,
                                            resolve_device)
from art_sbir_tpu_torch.scripts.probe_util import log

CORPUS = dict(n_classes=10, photos_per_class=100, sketches_per_photo=2,
              gen_size=128, learnable=True)
IMAGE_SIZE = 128
EPOCHS = 10
N_DISTRACTOR_CLASSES = 250
PHOTOS_PER_DISTRACTOR = 200  # 250 x 200 = 50,000 distractor photos
DISTRACTOR_CLASS_BASE = 1000  # disjoint from the training class ids
NPROBES = (1, 2, 4, 8, 16, 32)
PQ_M = 64
K = 10


def ensure_corpus(root: Path, corpus: dict = CORPUS) -> Path:
    """The learnable corpus under ``root/sketchy``, generated unless its
    marker records the same fields."""
    from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy

    sk = root / "sketchy"
    marker = sk / ".ann_learned_corpus.json"
    if marker.is_file() and json.loads(marker.read_text()) == corpus:
        return sk
    make_synthetic_sketchy(
        sk, n_classes=corpus["n_classes"],
        photos_per_class=corpus["photos_per_class"],
        sketches_per_photo=corpus["sketches_per_photo"],
        size=corpus["gen_size"], learnable=True)
    marker.write_text(json.dumps(corpus))
    return sk


def encoder_params(corpus: dict = CORPUS, image_size: int = IMAGE_SIZE,
                   width: int = 64,
                   layers: Sequence[int] = (3, 4, 6, 3)) -> dict:
    """The trained encoder's geometry, in ``training_params.json``'s
    keys."""
    return {"model_type": "ModifiedResNet_with_classification",
            "num_classes": corpus["n_classes"], "image_size": image_size,
            "width": width, "layers": list(layers)}


def train(root: Path, results_root: Path, seed: int, device,
          epochs: int = EPOCHS, params: dict | None = None) -> str:
    """Run ``cli/train.main`` on the recipe; returns the run's name, which
    is also its export's (``models/<run>.pt``)."""
    from art_sbir_tpu_torch.cli import train as train_cli

    params = params or encoder_params()
    argv = [
        "-e", str(epochs), "-b", "32", "-d", "SketchyV2",
        "--model_type", params["model_type"],
        "--num_classes", str(params["num_classes"]),
        "--data_root", str(root), "--image_size", str(params["image_size"]),
        "--split_ratio", "0.5", "-l", "1e-4",
        "--results_root", str(results_root), "--seed", str(seed),
        "--width", str(params["width"]),
        "--layers", *map(str, params["layers"]), "--device", str(device)]
    return train_cli.main(argv).name


def load_forward(run_name: str, device, params: dict | None = None):
    """The export ``models/<run_name>.pt`` (where ``cli/train.py`` saves
    it) as a bf16 uint8 (B, S, S, 3) -> (B, D) forward."""
    from art_sbir_tpu_torch.retrieval.engine import restore_encoder
    from art_sbir_tpu_torch.train.prepare import finish_gallery_batch

    model, restored = restore_encoder(run_name, params or encoder_params(),
                                      "models", resolve_device(device))
    if not restored:
        raise FileNotFoundError(f"no export models/{run_name}.pt")

    def forward(u8: torch.Tensor) -> torch.Tensor:
        out = model(finish_gallery_batch(u8))
        return out[0] if isinstance(out, (tuple, list)) else out

    return forward


def distractor_loader(start: int, count: int, image_size: int = IMAGE_SIZE,
                      photos_per_class: int = PHOTOS_PER_DISTRACTOR
                      ) -> np.ndarray:
    """Photos ``start .. start + count`` of the unseen classes from
    ``DISTRACTOR_CLASS_BASE`` on, rendered in memory (the embedding
    distribution is what matters; 50,000 JPEG round trips are not)."""
    from art_sbir_tpu_torch.data.synthetic import _learnable_photo

    out = np.empty((count, image_size, image_size, 3), np.uint8)
    for j in range(count):
        i = start + j
        out[j] = np.asarray(_learnable_photo(
            DISTRACTOR_CLASS_BASE + i // photos_per_class,
            i % photos_per_class, image_size))
    return out


def embed_corpus(forward, root: Path, device, image_size: int = IMAGE_SIZE,
                 n_distractors: int = N_DISTRACTOR_CLASSES
                 * PHOTOS_PER_DISTRACTOR,
                 photos_per_distractor: int = PHOTOS_PER_DISTRACTOR):
    """(gallery (N, D), queries (Q, D), positive row of each query,
    paired rows): the test photos then the distractors, and the test
    sketches, as float32 numpy."""
    from art_sbir_tpu_torch.data import get_datasets
    from art_sbir_tpu_torch.data.catalog import InferenceCatalog
    from art_sbir_tpu_torch.data.loader import GalleryLoader
    from art_sbir_tpu_torch.retrieval.embed import embed_batched

    # size=1.0: the factory's reference default is a 0.1 subsample
    _, test_cat = get_datasets(dataset="SketchyV2", size=1.0,
                               root=str(root), split_ratio=0.5)
    paired = InferenceCatalog(test_cat.photo_paths).image_paths
    mode = test_cat.resize_mode
    loader = GalleryLoader(paired, image_size, mode)
    g_paired = embed_batched(forward, loader, len(loader), 256, device=device)
    g_dis = embed_batched(
        forward, lambda s, c: distractor_loader(s, c, image_size,
                                                photos_per_distractor),
        n_distractors, 256, device=device)
    gallery = np.concatenate([g_paired, g_dis]).astype(np.float32)
    qloader = GalleryLoader(test_cat.sketch_paths, image_size, mode)
    queries = embed_batched(forward, qloader, len(qloader), 256,
                            device=device).astype(np.float32)
    row_of = {Path(p).stem: i for i, p in enumerate(paired)}
    pos = np.array([row_of[Path(s).stem.rsplit("-", 1)[0]]
                    for s in test_cat.sketch_paths], np.int64)
    return gallery, queries, pos, len(paired)


def gram_ranks(q: torch.Tensor, g: torch.Tensor, pos: torch.Tensor,
               chunk: int = 128) -> np.ndarray:
    """1 + the rows strictly closer than each query's positive, squared
    L2 in the Gram form (a broadcast difference would hold a (Q, N, D)
    block), ``chunk`` queries at a time."""
    ieee_f32()
    gg = (g * g).sum(-1)[None, :]
    out = []
    with torch.no_grad():
        for i in range(0, q.shape[0], chunk):
            qc = q[i:i + chunk]
            d = (qc * qc).sum(-1, keepdim=True) - 2.0 * qc @ g.T + gg
            dp = torch.gather(d, 1, pos[i:i + chunk, None])
            out.append((1 + (d < dp).sum(1)).cpu().numpy())
    return np.concatenate(out)


def engine_proxy(gallery: np.ndarray) -> np.ndarray:
    """The serving engine's auto-nprobe proxy: 256 gallery rows drawn by
    ``default_rng(0)`` plus 0.05 std gaussian noise."""
    prng = np.random.default_rng(0)
    rows = gallery[prng.integers(0, gallery.shape[0], 256)]
    return rows + 0.05 * rows.std() * prng.standard_normal(
        rows.shape).astype(np.float32)


def measure_tiers(gallery: np.ndarray, queries: np.ndarray, device) -> dict:
    """Every tier against the exact top-10 over the same embeddings; the
    golden's tier fields. The IVF sweep keeps the nprobe within the
    index's nlist."""
    from art_sbir_tpu_torch.ops.distance import retrieve_chunked
    from art_sbir_tpu_torch.ops.ivf import (apply_nprobe_margin, build_ivf,
                                            ivf_search, tune_nprobe)
    from art_sbir_tpu_torch.ops.pq import build_ivf_pq, ivf_pq_search
    from art_sbir_tpu_torch.ops.quant import (quantize_gallery,
                                              retrieve_quantized_chunked,
                                              topk_overlap)

    dev = resolve_device(device)
    g = torch.as_tensor(gallery, device=dev)
    q = torch.as_tensor(queries, device=dev)
    _, _, exact = retrieve_chunked(
        q, g, torch.zeros(q.shape[0], dtype=torch.int32, device=dev), k=K,
        chunk=256)
    exact = exact.cpu().numpy()
    out = {}

    qg = quantize_gallery(g)
    out["int8_overlap"] = {}
    for rf in (4, 8):
        _, ids = retrieve_quantized_chunked(q, qg, g, k=K, rerank_factor=rf)
        out["int8_overlap"][f"r{rf * K}"] = round(topk_overlap(ids, exact),
                                                  4)
        log(f"int8 top-10 overlap (rerank r={rf * K}): "
            f"{out['int8_overlap'][f'r{rf * K}']:.4f}")

    t0 = time.perf_counter()
    index = build_ivf(g, None)
    log(f"IVF built: nlist={index.nlist} ({time.perf_counter() - t0:.0f}s)")
    out["ivf_nlist"] = int(index.nlist)
    out["ivf_recall"] = {}
    for nprobe in (p for p in NPROBES if p <= index.nlist):
        _, ids = ivf_search(q, index, g, nprobe=nprobe, k=K)
        out["ivf_recall"][str(nprobe)] = round(topk_overlap(ids, exact), 4)
        log(f"IVF recall@10 nprobe={nprobe:>2}: "
            f"{out['ivf_recall'][str(nprobe)]:.4f}")

    # does the serving engine's proxy predict the real queries' nprobe?
    np_proxy = tune_nprobe(index, g, torch.as_tensor(engine_proxy(gallery),
                                                     device=dev), k=K)
    np_real = tune_nprobe(index, g, q, k=K)
    np_serving = apply_nprobe_margin(np_proxy, index.nlist)

    def ivf_recall(nprobe):
        _, ids = ivf_search(q, index, g, nprobe=nprobe, k=K)
        return round(topk_overlap(ids, exact), 4)

    out["tune_nprobe"] = {
        "proxy_choice": int(np_proxy), "real_query_choice": int(np_real),
        "real_recall_at_proxy_choice": ivf_recall(np_proxy),
        "serving_choice": int(np_serving),
        "real_recall_at_serving_choice": ivf_recall(np_serving)}
    log(f"tune_nprobe: {out['tune_nprobe']}")

    # residual IVF-PQ at nprobe 8 and at the tuned choices: at a low
    # nprobe the probe's own misses cap PQ's recall
    t0 = time.perf_counter()
    cb, codes = build_ivf_pq(g, index, PQ_M)
    log(f"residual IVF-PQ built (m={PQ_M}, {time.perf_counter() - t0:.0f}s)")
    g_bf16 = g.to(torch.bfloat16)
    pq = out["ivf_pq_recall"] = {}
    for nprobe in sorted({8, int(np_proxy), int(np_serving)}):
        _, ids = ivf_pq_search(q, index, codes, cb, nprobe=nprobe, k=K)
        pq[f"np{nprobe}_pure"] = round(topk_overlap(ids, exact), 4)
        for rf in (4, 16, 64):
            _, ids = ivf_pq_search(q, index, codes, cb, nprobe=nprobe, k=K,
                                   rows=g_bf16, rerank_factor=rf)
            pq[f"np{nprobe}_r{rf * K}"] = round(topk_overlap(ids, exact), 4)
    # OPQ on learned, correlated residuals
    cb_o, codes_o = build_ivf_pq(g, index, PQ_M, opq_iters=8)
    for rf, tag in ((0, "pure"), (64, "r640")):
        kw = {} if rf == 0 else {"rows": g_bf16, "rerank_factor": rf}
        _, ids = ivf_pq_search(q, index, codes_o, cb_o,
                               nprobe=int(np_serving), k=K, **kw)
        pq[f"opq_np{int(np_serving)}_{tag}"] = round(
            topk_overlap(ids, exact), 4)
    log(f"IVF-PQ recall@10: {pq}")
    return out


def write_golden(results: dict, out: Path) -> None:
    """The run's golden, whole: no key of an older file survives."""
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2, sort_keys=True))


def run(root: Path, results_root: Path, seed: int = 0, device="cuda",
        skip_train: str | None = None, corpus: dict = CORPUS,
        epochs: int = EPOCHS, image_size: int = IMAGE_SIZE,
        n_distractor_classes: int = N_DISTRACTOR_CLASSES,
        photos_per_distractor: int = PHOTOS_PER_DISTRACTOR,
        width: int = 64, layers: Sequence[int] = (3, 4, 6, 3)) -> dict:
    """Every stage; returns the golden."""
    dev = resolve_device(device)
    params = encoder_params(corpus, image_size, width, layers)
    sk = ensure_corpus(root, corpus)
    log(f"corpus at {sk}")
    t0 = time.perf_counter()
    run_name = skip_train or train(sk, results_root, seed, dev, epochs,
                                   params)
    t_train = time.perf_counter() - t0
    log(f"model export: {run_name} ({t_train:.0f}s)")

    t0 = time.perf_counter()
    forward = load_forward(run_name, dev, params)
    n_dis = n_distractor_classes * photos_per_distractor
    gallery, queries, pos, n_paired = embed_corpus(
        forward, sk, dev, image_size, n_dis, photos_per_distractor)
    t_embed = time.perf_counter() - t0
    log(f"embedded: gallery {gallery.shape[0]:,} ({n_paired} paired + "
        f"{n_dis:,} distractors), queries {queries.shape[0]:,} "
        f"({t_embed:.0f}s)")

    ranks = gram_ranks(torch.as_tensor(queries, device=dev),
                       torch.as_tensor(gallery, device=dev),
                       torch.as_tensor(pos, device=dev))
    n = gallery.shape[0]
    results = {
        "run_name": run_name, "corpus": corpus, "image_size": image_size,
        "epochs": epochs, "n_gallery": int(n), "n_paired": n_paired,
        "n_distractors": int(n_dis), "n_queries": int(queries.shape[0]),
        "mrr": float(np.mean(1.0 / ranks)),
        "chance_mrr": chance_mrr(n),
        "recall_at_1": float(np.mean(ranks == 1)),
        "recall_at_10": float(np.mean(ranks <= 10)),
        "backend": dev.type, **card_fields(dev),
    }
    log(f"MRR over {n:,} rows: {results['mrr']:.4f} (chance "
        f"{results['chance_mrr']:.2e}, "
        f"{results['mrr'] / results['chance_mrr']:.0f}x)")
    t0 = time.perf_counter()
    results.update(measure_tiers(gallery, queries, dev))
    results["wall_s"] = {"embed": round(t_embed, 1),
                         "tiers": round(time.perf_counter() - t0, 1)}
    if not skip_train:
        results["train_wall_s"] = round(t_train, 1)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="data/ann_learned_torch")
    ap.add_argument("--results_root", default="results_ann_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip_train", default=None,
                    help="reuse this models/ export instead of training")
    ap.add_argument("--out", default=None,
                    help="default goldens/torch_ann_learned_<cpu|cuda>.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results = run(Path(args.root), Path(args.results_root), args.seed,
                  args.device, args.skip_train)
    out = Path(args.out or f"goldens/torch_ann_learned_"
               f"{results['backend']}.json")
    write_golden(results, out)
    print(json.dumps({k: results[k] for k in
                      ("n_gallery", "mrr", "int8_overlap", "tune_nprobe")}))
    log(f"golden written to {out}")
    return results


if __name__ == "__main__":
    main()
