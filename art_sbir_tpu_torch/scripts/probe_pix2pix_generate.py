"""The eval-mode generate time of pix2pix's generators on the card, in
float32 and in bf16: ``Pix2Pix(Pix2PixConfig(net_g=..., bf16=...), seed
0).generate`` at 256 px, ``ngf`` 64, batch 6 (``cli/pix2pix.py``'s
defaults), timed with CUDA events.

    python -m art_sbir_tpu_torch.scripts.probe_pix2pix_generate [--reps 20]

It uses only ``Pix2Pix``'s public API, so it times whichever tree's
package is on the path: run it from a checkout of another commit
(``cd <checkout> && PYTHONPATH=. python <this file>``) to compare the two
in one call. One JSON line: the card's name and power limit, and for
each generator and form the median and the mean of ``--rounds`` rounds
of ``--reps`` launches, in ms.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from art_sbir_tpu_torch.core.device import ieee_f32
from art_sbir_tpu_torch.train.gan import Pix2Pix, Pix2PixConfig


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def rounds_ms(fn, rounds: int, reps: int) -> list:
    """``rounds`` means of ``reps`` launches each (CUDA events), after
    three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=6)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    ieee_f32()
    x = torch.rand((args.batch, 3, args.size, args.size),
                   generator=torch.Generator().manual_seed(0)).cuda()
    out = {"card": card(), "batch": args.batch, "size": args.size}
    with torch.no_grad():
        for net_g in ("resnet_9blocks", "unet_256"):
            for form, bf16 in (("f32", False), ("bf16", True)):
                model = Pix2Pix(Pix2PixConfig(net_g=net_g, bf16=bf16),
                                seed=0, device="cuda")
                ms = rounds_ms(lambda: model.generate(x), args.rounds,
                               args.reps)
                out[f"{net_g}_{form}"] = {"median_ms": float(np.median(ms)),
                                          "rounds_ms": ms}
                del model
                torch.cuda.empty_cache()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
