"""Transformation utilities CLI (reference `transformations.py:62-104`).

    python -m art_sbir_tpu_torch.cli.transformations -m dilate -o <folder>
    python -m art_sbir_tpu_torch.cli.transformations -m test_transform
        -o <sketch.png> [--out_dir transformations]

Counterpart of ``art_sbir_tpu/cli/transformations.py``, with the same
flags and ``--device``; both methods run on the card, ``--device cpu`` on
the CPU:

* ``dilate``: thicken thin synthetic sketches, a 4x4 grayscale dilation
  and a threshold at 250 (:func:`dilate_binarize`), into
  ``dilated_<folder>`` beside the input (`transformations.py:68-91`), one
  image at a time since sizes vary. Exact arithmetic: the same PNGs as
  the JAX package, bit for bit.
* ``test_transform``: write a few augmented samples of one sketch for a
  look (`transformations.py:62-66`). Sample ``i`` draws from a
  ``torch.Generator`` seeded with ``i`` where JAX takes
  ``jax.random.key(i)``; the streams differ, so the samples do too.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from art_sbir_tpu_torch.core.device import resolve_device
from art_sbir_tpu_torch.ops.augment import sketch_augment
from art_sbir_tpu_torch.ops.dilate import dilate_binarize


def dilate_folder(folder: Path, device: str | torch.device | None = None
                  ) -> Path:
    """Every ``*.png`` of ``folder`` dilated and binarized into
    ``dilated_<folder>``; returns that folder."""
    from PIL import Image

    dev = resolve_device(device)
    paths = sorted(folder.glob("*.png"))
    out_dir = folder.parent / f"dilated_{folder.name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for p in paths:
        img = torch.from_numpy(np.array(Image.open(p).convert("L"),
                                        np.uint8)).to(dev)
        out = dilate_binarize(img).cpu().numpy()
        Image.fromarray(out, mode="L").save(out_dir / p.name)
    print(f"{len(paths)} dilated sketches -> {out_dir}", flush=True)
    return out_dir


def test_transform(image_path: Path, out_dir: Path, n: int = 4,
                   version: int = 1,
                   device: str | torch.device | None = None) -> None:
    """``n`` augmented 224 px samples of one sketch,
    ``transformed_{i}.png``."""
    from PIL import Image

    dev = resolve_device(device)
    img = Image.open(image_path).convert("RGB").resize((224, 224),
                                                       Image.BICUBIC)
    x = torch.from_numpy(np.asarray(img, np.float32) / 255.0)[None].to(dev)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        gen = torch.Generator(device=dev).manual_seed(i)
        aug = sketch_augment(x, gen, version=version, do_normalize=False)
        arr = (aug[0] * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(arr).save(out_dir / f"transformed_{i}.png")
    print(f"{n} augmented samples -> {out_dir}", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--method", required=True,
                   choices=["test_transform", "dilate"])
    p.add_argument("-o", "--options", nargs="*", default=[])
    p.add_argument("--out_dir", default="transformations")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs on the CPU")
    args = p.parse_args(argv)
    if args.method == "dilate":
        dilate_folder(Path(args.options[0]), args.device)
    else:
        test_transform(Path(args.options[0]), Path(args.out_dir),
                       device=args.device)


if __name__ == "__main__":
    main()
