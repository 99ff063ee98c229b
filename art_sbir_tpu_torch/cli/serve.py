"""Retrieval serving CLI: a long-lived HTTP service on the card.

    python -m art_sbir_tpu_torch.cli.serve -f <run> [--features <cache>]
        [--data_root <root>] [--warmup]
        [--quantize [--rerank_factor 4] [--rerank_dtype float32|bfloat16]]
        [--ivf_nlist 0 [--ivf_nprobe 0] [--pq_m 64 [--pq_rerank bfloat16]
         [--pq_rerank_factor 64] [--pq_opq_iters 0]] [--index_cache DIR]]
        [--capacity N] [--n_devices N]

Counterpart of ``art_sbir_tpu/cli/serve.py``. The query encoder is
restored from ``<models_root>/<run>.pt`` (a seeded fresh init when it is
missing) and runs in bf16; the gallery, resident on the card, is a saved
feature cache under ``--feature_root`` or, without ``--features``, the
run's test gallery (its ``data_params.json`` catalog under
``--data_root``) embedded at startup, deduplicated and sorted as the
offline evaluation embeds it. The HTTP layer is stdlib
``ThreadingHTTPServer``. ``--quantize`` serves through the int8 candidate
scan and an exact rerank (K2 on the card). ``--ivf_nlist`` serves
through an IVF index built at startup (``ops/ivf.py``; 0: about 2*sqrt(N)
clusters), probing ``--ivf_nprobe`` clusters a query (0: auto-tuned at
startup); ``--pq_m`` adds residual IVF-PQ codes (``ops/pq.py``) with an
exact rerank on rows kept in ``--pq_rerank`` (``none`` drops them);
``--index_cache`` keeps the immutable index as ``.npz`` files, which a
restart loads (files of the JAX package's ``serve`` load too). Both
compose with ``--capacity`` (IVF only) and ``--n_devices``.
``--n_devices N`` (-1: every card) serves the gallery row-sharded over
the first N cards (with ``--device cpu``, N shards on the CPU); the
queries are embedded on the first.

Endpoints
---------
* ``GET /healthz`` -> ``{"status": "ok", "gallery_size": N, ...}``
* ``GET /stats``  -> request/batch counters (mean coalesced batch size)
* ``POST /search`` with ``{"image_b64": <base64 PNG/JPEG>, "k": 10}``
  -> ``{"paths": [...], "distances": [...]}`` (ascending), micro-batched
* ``POST /search_batch`` with ``{"images_b64": [...], "k": 10}`` -> one
  dispatch for the whole batch, ``{"results": [...]}``
* ``POST /add`` with ``{"image_b64": ..., "path": "name.jpg"}``,
  ``POST /remove`` with ``{"paths": [...]}`` and ``POST /save``: online
  index updates (requires ``--capacity``)
"""

from __future__ import annotations

import argparse
import base64
import copy
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from art_sbir_tpu_torch.core.checkpoint import checkpoint_path, load_state_dict
from art_sbir_tpu_torch.core.device import resolve_device
from art_sbir_tpu_torch.core.results import load_results
from art_sbir_tpu_torch.parallel.mesh import mesh_from_args
from art_sbir_tpu_torch.retrieval.engine import (embed_test_gallery,
                                                 rebuild_test_catalog,
                                                 restore_encoder)
from art_sbir_tpu_torch.retrieval.server import (MicroBatcher, RetrievalEngine,
                                                 engine_from_feature_cache)
from art_sbir_tpu_torch.train.prepare import finish_gallery_batch


def build_engine(args, mesh=None):
    """(engine, batcher) from parsed CLI arguments. Programmatic callers
    may pass a partial namespace: absent options take their defaults.
    ``mesh`` (:class:`~art_sbir_tpu_torch.parallel.mesh.Mesh`) takes the
    place of the one ``--n_devices`` builds, such as several shards on one
    card."""
    device = resolve_device(getattr(args, "device", None))
    if mesh is None:
        mesh = mesh_from_args(getattr(args, "n_devices", 1), device=device)
    if mesh is not None:
        device = mesh.devices[0]
    run_dir = Path(args.results_root) / args.folder
    results = load_results(run_dir)
    data_dict = results.get("data_params", {})
    param_dict = results.get("training_params", {})
    if not args.features and "dataset" not in data_dict:
        raise SystemExit(
            f"results folder {run_dir} has no data_params.json — pass a "
            "trained run folder, or serve a saved gallery with --features")

    loss_type = args.metric or param_dict.get("loss_type", "euclidean")
    image_size = int(param_dict.get("image_size", 224))
    model, restored = restore_encoder(args.folder, param_dict,
                                      args.models_root, device)
    if not restored:
        print(f"Model {args.folder} not found — serving fresh init",
              flush=True)

    def make_forward(encoder):
        def forward(images_uint8):
            return encoder(finish_gallery_batch(images_uint8))
        return forward

    # Per-modality BN: a run trained with per-modality recalibration
    # exports sketch-population running stats as `<run>_bn_sketch`; HTTP
    # queries are sketches, so they are embedded with those stats while
    # the gallery keeps the main export's. 'auto' looks for the sibling
    # only beside a restored checkpoint: its stats belong to those weights.
    query_forward = None
    bn_arg = getattr(args, "bn_stats", "auto") or "auto"
    if bn_arg != "off":
        sib = (checkpoint_path(args.models_root, f"{args.folder}_bn_sketch")
               if bn_arg == "auto" else Path(bn_arg))
        if sib.is_file() and (bn_arg != "auto" or restored):
            query_model = copy.deepcopy(model)
            bad = query_model.load_state_dict(load_state_dict(sib),
                                              strict=False).unexpected_keys
            if bad:
                raise SystemExit(f"--bn_stats {sib}: unexpected keys {bad}")
            query_forward = make_forward(query_model)
            print(f"query encoder: sketch-population BN stats ({sib})",
                  flush=True)
        elif bn_arg != "auto":
            raise SystemExit(f"--bn_stats {bn_arg}: no export at {sib}")

    forward = make_forward(model)
    kw = dict(metric=loss_type, image_size=image_size,
              k_max=getattr(args, "k_max", 10),
              max_batch=getattr(args, "max_batch", 32),
              capacity=getattr(args, "capacity", None),
              quantize=getattr(args, "quantize", False),
              rerank_factor=getattr(args, "rerank_factor", 4),
              rerank_dtype=getattr(args, "rerank_dtype", "float32"),
              ivf_nlist=getattr(args, "ivf_nlist", None),
              ivf_nprobe=getattr(args, "ivf_nprobe", 0),
              pq_m=getattr(args, "pq_m", None),
              pq_rerank=getattr(args, "pq_rerank", "bfloat16"),
              pq_rerank_factor=getattr(args, "pq_rerank_factor", 64),
              pq_opq_iters=getattr(args, "pq_opq_iters", 0),
              index_cache=getattr(args, "index_cache", None),
              query_forward_fn=query_forward, device=device, mesh=mesh)
    resize_mode = param_dict.get("resize_mode")  # else the catalog's
    if args.features:
        engine = engine_from_feature_cache(
            forward, args.features, root=args.feature_root,
            resize_mode=resize_mode or "square", **kw)
    else:
        # the offline evaluation's gallery: engine.run_inference embeds it
        test_cat = rebuild_test_catalog(data_dict,
                                        getattr(args, "data_root", None))
        resize_mode = resize_mode or getattr(test_cat, "resize_mode",
                                             "square")
        paths, feats = embed_test_gallery(
            forward, test_cat, image_size, resize_mode,
            getattr(args, "embed_batch", 256), device)
        engine = RetrievalEngine(forward, feats, paths,
                                 resize_mode=resize_mode, **kw)
    return engine, MicroBatcher(engine, window_ms=args.window_ms)


def _png(arr_u8: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, "PNG")
    return buf.getvalue()


def warmup(engine, batcher=None) -> None:
    """Run every path a request can take once before binding the port
    (cuDNN's algorithm choice per batch bucket, the build and first
    launch of the route's kernel, K1 or K2): the search per bucket and,
    for capacity engines, the gallery embedding per bucket and the
    ``/add`` path's decode + embedding. Nothing is written into the index, so a capacity engine
    that starts full is warmed the same way and no slot moves. With
    ``batcher``, all of it runs on the batcher's thread, where the server
    runs its device work: cuDNN's plans are kept per thread."""
    if batcher is not None:
        batcher.call(lambda: warmup(engine))
        return
    s = engine.image_size
    for b in engine.buckets:
        engine.search_arrays(np.zeros((b, s, s, 3), np.uint8))
        if engine.capacity is not None:
            engine.embed_gallery(np.zeros((b, s, s, 3), np.uint8))
    if engine.capacity is not None:
        engine.embed_items([(_png(np.zeros((s, s, 3), np.uint8)),
                             "__warmup__.png")])


class Server(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog that holds a burst of
    concurrent clients. At socketserver's default of 5, connection
    requests that arrive while the accepting thread waits for the
    interpreter lock overflow the backlog, and the clients' TCP stacks
    send them again a second later."""

    request_queue_size = 128


def make_handler(engine, batcher):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, engine.health_stats())
            elif self.path == "/stats":
                self._json(200, batcher.stats.snapshot())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path not in ("/search", "/search_batch", "/add",
                                 "/remove", "/save"):
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n)) if n else {}
                if self.path == "/save":
                    self._json(200, {"folder": batcher.call(
                        lambda: engine.save(dataset_name=req.get(
                            "dataset_name", "online")))})
                    return
                if self.path == "/remove":
                    freed = batcher.call(lambda: engine.remove(req["paths"]))
                    self._json(200, {"removed": freed,
                                     "gallery_size": int(engine.n_valid)})
                    return
                if self.path == "/search_batch":
                    # a client batch is one dispatch (no micro-batching)
                    imgs = np.stack([engine.decode(base64.b64decode(b))
                                     for b in req["images_b64"]])
                    vals, idx = batcher.call(
                        lambda: engine.search_arrays(imgs))
                    self._json(200, {"results": [
                        engine._result(vals[i], idx[i], req.get("k"))
                        for i in range(len(imgs))]})
                    return
                data = base64.b64decode(req["image_b64"])
                if self.path == "/add":
                    idx = batcher.call(
                        lambda: engine.add_images([(data, req["path"])]))
                    self._json(200, {"indices": idx,
                                     "gallery_size": int(engine.n_valid)})
                else:
                    self._json(200, batcher.search(data, k=req.get("k")))
            except TimeoutError as e:  # server-side stall, not a bad request
                self._json(503, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # malformed request or decode failure
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *a):  # quiet; /stats has the counters
            pass

    return Handler


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-f", "--folder", required=True,
                   help="results run folder (checkpoint + training params)")
    p.add_argument("--features", default=None,
                   help="serve a saved gallery cache from feature_root; "
                        "without it, embed the run's test gallery")
    p.add_argument("--data_root", default=None,
                   help="dataset root of the run's catalog (without "
                        "--features)")
    p.add_argument("--embed_batch", type=int, default=256,
                   help="batch of the startup gallery embedding")
    p.add_argument("--results_root", default="results")
    p.add_argument("--models_root", default="models")
    p.add_argument("--feature_root", default="data/image_features")
    p.add_argument("--metric", default=None, choices=("euclidean", "cosine"),
                   help="override the run's loss_type")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8081)
    p.add_argument("--k_max", type=int, default=10)
    p.add_argument("--capacity", type=int, default=None,
                   help="fixed index capacity; enables online POST /add")
    p.add_argument("--quantize", action="store_true",
                   help="int8 candidate scan + exact rerank (ops/quant.py; "
                        "immutable indexes)")
    p.add_argument("--rerank_factor", type=int, default=4,
                   help="quantized candidate count = factor * k_max")
    p.add_argument("--rerank_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 keeps the rerank gallery resident in "
                        "bf16 (0.75 B/elem total vs 1.25 f32) at ~1e-2 "
                        "relative value rounding; quantized mode only")
    p.add_argument("--ivf_nlist", type=int, default=None,
                   help="build an IVF clustered index (ops/ivf.py) and "
                        "probe --ivf_nprobe clusters a query instead of a "
                        "full scan (0 = auto ~2*sqrt(N) clusters); "
                        "approximate, scored distances exact; composes "
                        "with --capacity (online IVF) and --n_devices "
                        "(one local index a shard; with both, shared "
                        "centroids and per-shard mutable tables)")
    p.add_argument("--ivf_nprobe", type=int, default=0,
                   help="clusters probed a query; 0 = auto-tune at startup "
                        "(smallest power of two reaching 95%% recall@k_max "
                        "on perturbed gallery rows, then doubled: the proxy "
                        "measured one power of two optimistic against real "
                        "cross-modal queries)")
    p.add_argument("--pq_m", type=int, default=None,
                   help="IVF-PQ (ops/pq.py; requires --ivf_nlist): residual "
                        "codes of this many bytes a row, ADC-scored; "
                        "composes with --n_devices")
    p.add_argument("--pq_rerank", default="bfloat16",
                   choices=["none", "float32", "bfloat16"],
                   help="residency of the exact rows reranking the best "
                        "pq_rerank_factor*k_max ADC candidates; 'none' "
                        "drops the rows (approximate values)")
    p.add_argument("--pq_rerank_factor", type=int, default=64,
                   help="PQ exact-rerank candidates = factor * k_max")
    p.add_argument("--pq_opq_iters", type=int, default=0,
                   help="learn an OPQ rotation with this many alternating "
                        "iterations (0 = plain residual PQ)")
    p.add_argument("--index_cache", default=None,
                   help="directory keeping the built IVF (+PQ) index as "
                        ".npz; a restart loads it where it matches; "
                        "immutable --ivf_nlist indexes only")
    p.add_argument("--n_devices", type=int, default=1,
                   help="shard the gallery's rows over the first N cards "
                        "(-1: all; N shards on the CPU with --device cpu); "
                        "rows (or capacity) divisible by N")
    p.add_argument("--max_batch", type=int, default=32)
    p.add_argument("--window_ms", type=float, default=2.0)
    p.add_argument("--bn_stats", default="auto",
                   help="query-side BatchNorm stats: 'auto' loads "
                        "<models_root>/<folder>_bn_sketch.pt beside a "
                        "restored checkpoint; 'off'; or an explicit path")
    p.add_argument("--warmup", action="store_true",
                   help="run every batch bucket before listening")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    engine, batcher = build_engine(args)
    if args.warmup:
        warmup(engine, batcher)
    httpd = Server((args.host, args.port), make_handler(engine, batcher))
    cap = "" if engine.capacity is None else f" (capacity {engine.capacity})"
    print(f"serving {engine.n_valid}-image gallery{cap} on "
          f"http://{args.host}:{httpd.server_address[1]} "
          f"(metric={engine.metric}, k_max={engine.k_max}, "
          f"max_batch={engine.max_batch}, device={engine.device}, "
          f"shards={engine.n_shards}, route={engine.route})",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.close()
        httpd.server_close()


if __name__ == "__main__":
    main()
