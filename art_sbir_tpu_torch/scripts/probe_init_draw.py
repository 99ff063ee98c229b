"""Whether the encoder's fresh init is the same weights on every machine,
and what one draw costs: a hash of ``models/resnet.py::create_encoder``'s
state (JAX's init, drawn on the host by ``models/flax_draw.py``) and the
host seconds of the draw, uncached.

    python -m art_sbir_tpu_torch.scripts.probe_init_draw [--seed 0]

One JSON line: the torch and numpy versions, the host's thread count
and, for the configurations of the card goldens (``ci`` at 64 px and 3
classes; ``learn`` and ``probe_ann_learned`` at 128 px and 10;
``scale_learn`` at 224 px and 25) and the flagship (224 px, 125
classes), the first 16 hex digits of a SHA-256 over every tensor of the
state dict in float32 and the seconds ``create_encoder`` took. The draw
is IEEE arithmetic on the CPU, so the hashes should be the same on every
host.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch
from torch import nn

from art_sbir_tpu_torch.models import flax_draw
from art_sbir_tpu_torch.models.resnet import create_encoder

CONFIGS = {"ci": (3, 64), "learn": (10, 128), "scale_learn": (25, 224),
           "flagship": (125, 224)}


def digest(model: nn.Module) -> str:
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = {"torch": torch.__version__, "numpy": np.__version__,
           "threads": torch.get_num_threads(), "seed": args.seed}
    for name, (classes, res) in CONFIGS.items():
        flax_draw.encoder_state.cache_clear()
        t0 = time.perf_counter()
        model = create_encoder(with_classification=True, num_classes=classes,
                               device="cpu", seed=args.seed,
                               input_resolution=res)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[name] = digest(model)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
