"""Informative-drawings batch inference CLI (reference `drawings_main.py`
and `create_drawings.py`).

    python -m art_sbir_tpu_torch.cli.drawings [--corpus kaggle|sketchy]
        [--model contour.pth] [--bf16] [--device cuda|cpu] ...

Counterpart of ``art_sbir_tpu/cli/drawings.py``, with the same flags and
``--device``. Loads a DrawingGenerator ({contour, anime, opensketch}) and
writes a line drawing of every image of a corpus: Kaggle ->
``<data_root>/<name>_drawings/<stem>.png``; Sketchy -> one folder a class
under ``<data_root>/<name>_drawings/``. It runs on the card; ``--device
cpu`` runs it on the CPU.

* ``--model``: a reference ``.pth`` or a port ``.pt`` (both the reference
  layout). Without it the generator takes JAX's own fresh init,
  ``model.init(jax.random.key(0))``, drawn on the host without JAX
  (``models/flax_families.py``). An orbax directory is refused, naming
  ``scripts/orbax_to_pt.py``, which converts it.
* ``--bf16``: weights and input in bf16, the output back in float32 (JAX
  ``drawings.py:61-66``). Float32 runs IEEE on the card (no TF32).
* A drawing is ``uint8(img * 255)``, truncating, as JAX writes it.
* Three stages overlap: the decode of batch k+1 on a prefetch thread (into
  pinned memory, so its upload is queued without a wait), the forward of
  batch k on the card, the PNG write of batch k-1 here. Each output goes
  to pinned host memory by a copy queued right after its forward, with an
  event recorded behind it; the write of k-1 waits on k-1's event only.
  (``.cpu()`` there would wait for forward k too, and serialize the
  stages.)

The last line printed gives the wall time and its split: decode (on the
prefetch thread, overlapped), the host's wait on the prefetch, forward
(the card's time between events around each batch) and write.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from art_sbir_tpu_torch.core.checkpoint import ORBAX_DIR, load_state_dict
from art_sbir_tpu_torch.core.device import ieee_f32, resolve_device
from art_sbir_tpu_torch.data.loader import decode_paths
from art_sbir_tpu_torch.models import flax_families
from art_sbir_tpu_torch.models.drawing import DrawingGenerator
from art_sbir_tpu_torch.models.port_weights import (load_into,
                                                    load_reference_pth)

NOT_A_MODEL = f"{ORBAX_DIR}; or pass a reference .pth or a port .pt"


def load_generator(model: Optional[str], device: torch.device,
                   bf16: bool = False) -> DrawingGenerator:
    """The generator of ``--model`` (a reference ``.pth`` or a port
    ``.pt``; JAX's fresh init for ``key(0)`` without one) on ``device``,
    in eval mode, bf16 with ``bf16``."""
    gen = DrawingGenerator()
    gen.load_state_dict(flax_families.drawing_generator(0))
    if model is not None:
        if Path(model).is_dir():
            raise SystemExit(f"--model {model}: {NOT_A_MODEL}")
        sd = (load_reference_pth(model) if model.endswith(".pth")
              else load_state_dict(model))
        load_into(gen, sd, f"DrawingGenerator from {model}")
    gen = gen.to(device).eval()
    return gen.to(torch.bfloat16) if bf16 else gen


def corpus_paths(args) -> Tuple[List[Path], Path]:
    """(image paths, output folder) of ``--corpus``."""
    if args.corpus == "kaggle":
        from art_sbir_tpu_torch.data import get_datasets

        train, test = get_datasets("KaggleDatasetImgOnlyV1", size=args.dsize,
                                   img_type=args.img_type,
                                   root=args.data_root)
        root = Path(args.data_root) if args.data_root else Path("data/kaggle")
        return (list(train.photo_paths) + list(test.photo_paths),
                root / f"{args.name}_drawings")
    # reference create_drawings.py:78 builds an UnpairedDepthDataset per
    # class folder in test mode (recursive glob, 10k cap a class)
    from art_sbir_tpu_torch.data.unpaired import UnpairedImageCatalog

    root = Path(args.data_root) if args.data_root else Path("data/sketchy")
    classes = args.classes or sorted(
        d.name for d in (root / "photos").iterdir() if d.is_dir())
    paths = [p for cls in classes
             for p in UnpairedImageCatalog(root / "photos" / cls,
                                           mode="test").paths]
    return paths, root / f"{args.name}_drawings"


def forward_u8(gen: DrawingGenerator, u8: torch.Tensor, bf16: bool = False
               ) -> torch.Tensor:
    """(B, H, W, 3) uint8 on the generator's device -> (B, H, W) uint8
    drawings: ``x / 255`` in float32 (then bf16 with ``bf16``), the
    forward, the output in float32, ``* 255`` truncated."""
    x = u8.permute(0, 3, 1, 2).float() / 255.0
    with torch.inference_mode():
        out = gen(x.to(torch.bfloat16) if bf16 else x).float()
    return (out[:, 0] * 255).to(torch.uint8)


def launch(forward: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
           device: torch.device):
    """Queue the upload of the uint8 batch ``x``, ``forward`` of it (uint8
    out) and the copy of the result into pinned host memory; returns (host
    result, a function that waits for it and gives the seconds from the
    upload to the copy's end, timed by events on the card)."""
    if device.type != "cuda":
        t = time.perf_counter()
        out = forward(x.to(device))
        seconds = time.perf_counter() - t
        return out, lambda: seconds
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    u8 = forward(x.to(device, non_blocking=True))
    host = torch.empty(u8.shape, dtype=u8.dtype, pin_memory=True)
    host.copy_(u8, non_blocking=True)
    end.record()

    def wait() -> float:
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    return host, wait


def overlapped(chunks: Sequence[Sequence[Path]],
               decode: Callable[[Sequence[Path]], np.ndarray],
               forward: Callable[[torch.Tensor], torch.Tensor],
               write: Callable[[np.ndarray, Sequence[Path]], None],
               device: torch.device) -> Dict[str, float]:
    """The three overlapped stages over ``chunks`` of paths: ``decode`` of
    chunk k+1 on the prefetch thread, ``forward`` of chunk k on the
    device (:func:`launch`), ``write`` of chunk k-1's uint8 results here.
    Returns the wall time and its split (seconds): decode (on the
    prefetch thread), the host's wait on it, forward, write."""
    cuda = device.type == "cuda"
    stats = {"decode_s": 0.0, "wait_s": 0.0, "forward_s": 0.0,
             "write_s": 0.0}

    def fetch(chunk):
        t = time.perf_counter()
        x = torch.from_numpy(decode(chunk))
        # pinned, so the upload is queued without waiting for the card
        return chunk, x.pin_memory() if cuda else x, time.perf_counter() - t

    def finish(host: torch.Tensor, wait, chunk) -> None:
        stats["forward_s"] += wait()
        t = time.perf_counter()
        write(host.numpy(), chunk)
        stats["write_s"] += time.perf_counter() - t

    t_wall = time.perf_counter()
    pending = None  # (host results, their wait, chunk) of the last batch
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(fetch, chunks[0]) if chunks else None
        for i in range(len(chunks)):
            t = time.perf_counter()
            chunk, x, decode_s = future.result()
            stats["wait_s"] += time.perf_counter() - t
            stats["decode_s"] += decode_s
            future = (pool.submit(fetch, chunks[i + 1])
                      if i + 1 < len(chunks) else None)
            host, wait = launch(forward, x, device)
            if pending is not None:
                finish(*pending)
            pending = (host, wait, chunk)
        if pending is not None:
            finish(*pending)
    stats["wall_s"] = time.perf_counter() - t_wall
    return stats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="generate line drawings")
    p.add_argument("-n", "--name", default="contour",
                   choices=["contour", "anime", "opensketch"])
    p.add_argument("--model", type=str, default=None,
                   help="a reference .pth (drawing_models/{contour,anime,"
                        "opensketch}.pth, reference drawings_main.py:88) or "
                        "a port .pt; a seeded fresh init if omitted")
    p.add_argument("--corpus", choices=["kaggle", "sketchy"], default="kaggle")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--img_type", default="images")
    p.add_argument("--classes", nargs="*", default=None,
                   help="sketchy class shard (reference create_drawings.py)")
    p.add_argument("-b", "--batch_size", type=int, default=16)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--dsize", type=float, default=1.0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 generator compute; outputs differ from "
                        "float32 at the quantization level")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs on the CPU")
    return p


def main(argv=None) -> Dict[str, float]:
    """Write the drawings; returns the count, the wall time and its split
    (seconds)."""
    from PIL import Image

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ieee_f32()
    gen = load_generator(args.model, device, args.bf16)
    paths, out_dir = corpus_paths(args)
    out_dir.mkdir(parents=True, exist_ok=True)

    def write(imgs: np.ndarray, chunk) -> None:
        for img, path in zip(imgs, chunk):
            dest = out_dir
            if args.corpus == "sketchy":
                dest = out_dir / Path(path).parent.name
                dest.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img, mode="L").save(
                dest / f"{Path(path).stem}.png")

    chunks = [paths[s: s + args.batch_size]
              for s in range(0, len(paths), args.batch_size)]
    stats = {"images": len(paths), **overlapped(
        chunks, lambda chunk: decode_paths(chunk, args.image_size),
        lambda u8: forward_u8(gen, u8, args.bf16), write, device)}
    print(f"{len(paths)} drawings written to {out_dir} in "
          f"{stats['wall_s']:.3f} s (decode {stats['decode_s']:.3f} s on the "
          f"prefetch thread, waited {stats['wait_s']:.3f} s; forward "
          f"{stats['forward_s']:.3f} s; write {stats['write_s']:.3f} s)",
          flush=True)
    return stats


if __name__ == "__main__":
    main()
