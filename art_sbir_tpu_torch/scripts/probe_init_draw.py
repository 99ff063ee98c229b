"""Whether the flagship's seed-0 fresh init is the same weights on every
torch release: a hash of ``models/resnet.py::create_encoder``'s state as
``models/layers.py::lecun_normal_`` draws it, beside the same
distribution drawn by ``nn.init.trunc_normal_`` in the same order.

    python -m art_sbir_tpu_torch.scripts.probe_init_draw

One JSON line: the torch version and, for the configurations of the
card goldens (``ci`` at 64 px and 3 classes; ``learn`` and
``probe_ann_learned`` at 128 px and 10; ``scale_learn`` at 224 px and
25), the first 16 hex digits of a SHA-256 over every tensor of the
state dict in float32. ``lecun_normal_``'s hash should be the same on
every release; ``trunc_normal_``'s equals it where that release draws
as ``jax.random.truncated_normal`` does (torch 2.11 did; a golden
recorded with ``trunc_normal_`` there holds the same weights). Runs on
the CPU: the init is drawn there on every device.
"""

from __future__ import annotations

import hashlib
import json

import torch
from torch import nn

from art_sbir_tpu_torch.models import layers
from art_sbir_tpu_torch.models.resnet import create_encoder

CONFIGS = {"ci": (3, 64), "learn": (10, 128), "scale_learn": (25, 224)}


def digest(model: nn.Module) -> str:
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@torch.no_grad()
def trunc_normal_lecun_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """``lecun_normal_``'s distribution through ``nn.init.trunc_normal_``."""
    std = (1.0 / weight[0].numel()) ** 0.5 / layers.TRUNC_NORMAL_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=gen)


def main() -> dict:
    out = {"torch": torch.__version__}
    for name, (classes, res) in CONFIGS.items():
        for draw in ("lecun_normal_", "trunc_normal_"):
            own = layers.lecun_normal_
            if draw == "trunc_normal_":
                layers.lecun_normal_ = trunc_normal_lecun_
            try:
                model = create_encoder(with_classification=True,
                                       num_classes=classes, device="cpu",
                                       seed=0, input_resolution=res)
            finally:
                layers.lecun_normal_ = own
            out[f"{name}/{draw}"] = digest(model)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
