"""AdaIN style-transfer CLI (reference `artwork_gen.py`).

    python -m art_sbir_tpu_torch.cli.artwork_gen --content_dir <photos>
        --style_dir <styles> [--model <dir>|vgg.pth,decoder.pth]
        [--alpha 1.0] [--device cuda|cpu] ...

Counterpart of ``art_sbir_tpu/cli/artwork_gen.py``, with the same flags
and ``--device``. For each content photo it draws a style image with
``random.Random(seed).choice``, Python's own generator, so it pairs each
photo with the same style as the JAX package, and writes
``style_transfer(content, style, alpha)`` clipped to [0, 1], truncated to
uint8, as ``<out_dir>/<stem>.jpg`` (the reference's synthetic 'artworks'
and 'adain_sketches', `artwork_gen.py:95-115`). Batched on the card;
``--device cpu`` runs on the CPU. Float32 runs IEEE on the card.

``--model``: a directory holding the published ``vgg_normalised.pth`` and
``decoder.pth``, or the comma-joined pair. Without it the encoder and the
decoder take JAX's init distributions (``models/layers.py::flax_init``)
from ``torch.Generator``s seeded with 0 and 1, where the JAX package
takes ``jax.random.key(0)`` and ``key(1)``. An orbax directory is
refused, naming ``scripts/orbax_to_pt.py``, which converts it into the
directory form.
"""

from __future__ import annotations

import argparse
import random
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from art_sbir_tpu_torch.core.checkpoint import ORBAX_DIR
from art_sbir_tpu_torch.core.device import ieee_f32, resolve_device
from art_sbir_tpu_torch.data.loader import decode_image
from art_sbir_tpu_torch.models.adain_net import (AdaINDecoder, AdaINEncoder,
                                                 style_transfer)
from art_sbir_tpu_torch.models.layers import flax_init
from art_sbir_tpu_torch.models.port_weights import load_adain_pth, load_into

NOT_A_MODEL = (f"{ORBAX_DIR}; or pass a directory holding "
               "vgg_normalised.pth and decoder.pth, or the comma-joined pair")


def load_adain(model: Optional[str], device: torch.device
               ) -> Tuple[AdaINEncoder, AdaINDecoder]:
    """(encoder, decoder) of ``--model`` on ``device``, in eval mode; a
    seeded fresh init without it."""
    enc = flax_init(AdaINEncoder(), seed=0)
    dec = flax_init(AdaINDecoder(), seed=1)
    if model is not None:
        if not ((Path(model) / "vgg_normalised.pth").exists()
                or model.endswith(".pth")):
            raise SystemExit(f"--model {model}: {NOT_A_MODEL}")
        enc_sd, dec_sd = load_adain_pth(model)
        load_into(enc, enc_sd, f"AdaIN encoder from {model}")
        load_into(dec, dec_sd, f"AdaIN decoder from {model}")
    return enc.to(device).eval(), dec.to(device).eval()


def _batch(paths, size: int, device: torch.device) -> torch.Tensor:
    """Decoded images as NCHW float32 in [0, 1] on ``device``. The division
    runs in float64 on the host, then rounds to float32, as the JAX CLI's
    ``np.stack(...) / 255.0`` does."""
    x = np.stack([decode_image(p, size) for p in paths]) / 255.0
    return torch.from_numpy(x.astype(np.float32)).permute(0, 3, 1, 2).to(
        device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="AdaIN style transfer")
    p.add_argument("--content_dir", required=True)
    p.add_argument("--style_dir", required=True)
    p.add_argument("--out_dir", default="data/kaggle/adain_sketches")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--model", type=str, default=None,
                   help="a dir holding the published vgg_normalised.pth + "
                        "decoder.pth (reference utils.py:153-160), or the "
                        "comma-joined pair")
    p.add_argument("-b", "--batch_size", type=int, default=8)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs on the CPU")
    return p


def main(argv=None) -> Dict[str, float]:
    """Write the stylized images; returns the count, the wall time, the
    forward's share of it and each content image's style
    (``pairs``: content stem -> style path)."""
    from PIL import Image

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ieee_f32()
    enc, dec = load_adain(args.model, device)

    exts = ("*.jpg", "*.jpeg", "*.png")
    content_paths = sorted(q for e in exts
                           for q in Path(args.content_dir).rglob(e))
    style_paths = sorted(q for e in exts
                         for q in Path(args.style_dir).rglob(e))
    if args.limit:
        content_paths = content_paths[: args.limit]
    if not content_paths or not style_paths:
        raise FileNotFoundError("no content or style images found")

    rng = random.Random(args.seed)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pairs: Dict[str, str] = {}
    forward_s = 0.0
    t_wall = time.perf_counter()
    for i in range(0, len(content_paths), args.batch_size):
        chunk = content_paths[i: i + args.batch_size]
        styles = [rng.choice(style_paths) for _ in chunk]
        pairs.update((c.stem, str(s)) for c, s in zip(chunk, styles))
        content = _batch(chunk, args.image_size, device)
        style = _batch(styles, args.image_size, device)
        t = time.perf_counter()
        with torch.inference_mode():
            out = style_transfer(enc, dec, content, style, args.alpha)
        out = (out.clamp(0, 1) * 255).to(torch.uint8).permute(0, 2, 3, 1)
        out = out.cpu().numpy()
        forward_s += time.perf_counter() - t
        for img, path in zip(out, chunk):
            Image.fromarray(img).save(out_dir / f"{path.stem}.jpg")
    wall_s = time.perf_counter() - t_wall
    print(f"{len(content_paths)} stylized images written to {out_dir} in "
          f"{wall_s:.3f} s (forward and copy back {forward_s:.3f} s)",
          flush=True)
    return {"images": len(content_paths), "wall_s": wall_s,
            "forward_s": forward_s, "pairs": pairs}


if __name__ == "__main__":
    main()
