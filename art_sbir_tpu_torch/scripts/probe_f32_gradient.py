"""How far one float32 triplet step's gradient lies from float64 on the
card, with and without cuDNN.

    python -m art_sbir_tpu_torch.scripts.probe_f32_gradient

The flagship ModifiedResNet50 with the 125-class head, one Adam step
(``probe_dp_cards.triplet_steps``: augmentation V1 and the paired flip
on, TF32 off) on the phase's seeded batch at B = 32 and at its first 16
rows, in float64 (cuDNN on), then in float32 with cuDNN, with cuDNN
deterministic and with cuDNN off. One JSON line a run: the flat
gradient's relative L2 distance from float64, the loss, the seconds,
and the four tensors that carry most of the error (share of the error's
squared norm, the tensor's own relative error). It says whether a
float32 gradient's distance from float64 is cuDNN's algorithms or
float32 itself; ``probe_dp_cards.failures`` holds the data-parallel
gradient to float64 by it.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from art_sbir_tpu_torch.scripts import probe_dp_cards as P


def one_step(u8: dict, dtype_name: str, rows: int, cudnn: bool = True,
             deterministic: bool = False):
    torch.backends.cudnn.enabled = cudnn
    torch.backends.cudnn.deterministic = deterministic
    t = time.perf_counter()
    try:
        out = P.triplet_steps({k: v[:rows] for k, v in u8.items()}, P.FULL,
                              "cuda:0", dtype_name, steps=1)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.enabled = True
        torch.backends.cudnn.deterministic = False
    return out, time.perf_counter() - t


def main() -> None:
    u8 = P.make_inputs(np.random.default_rng(41), P.FULL, b=32)["u8"]
    for rows in (32, 16):
        exact, _ = one_step(u8, "float64", rows)
        e = exact["grads"][0].double()
        for tag, kw in (("cudnn", {}), ("cudnn_deterministic",
                                         {"deterministic": True}),
                        ("no_cudnn", {"cudnn": False})):
            got, s = one_step(u8, "float32", rows, **kw)
            err = got["grads"][0].double() - e
            o, parts = 0, []
            for name, n in exact["grad_names"]:
                piece = err[o:o + n]
                parts.append((float(piece.norm() ** 2 / err.norm() ** 2),
                              name, float(piece.norm()
                                          / e[o:o + n].norm().clamp_min(
                                              1e-30))))
                o += n
            parts.sort(reverse=True)
            print(json.dumps({"rows": rows, "run": tag,
                              "rel_l2_vs_f64": float(err.norm() / e.norm()),
                              "loss": got["losses"][0]["loss"],
                              "loss_f64": exact["losses"][0]["loss"],
                              "s": s, "error_share": parts[:4]}),
                  flush=True)


if __name__ == "__main__":
    main()
