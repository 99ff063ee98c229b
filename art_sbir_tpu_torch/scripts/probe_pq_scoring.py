"""Three lowerings of the IVF-PQ scan's ADC score, raced on the card.

Counterpart of the JAX package's ``scripts/probe_pq_scoring.py``. The
residual IVF-PQ scan scores gathered candidate codes against per-(query,
probe) tables, ``score[b, c] = sum_m LUT[b, m, codes[b, c, m]]``:

* ``onehot_f32``: JAX's shipped form, a loop over M, each step a float32
  one-hot (B, C, K) x (B, K) batched matmul (IEEE float32: exact, since a
  one-hot row selects one table entry); the one-hot operand moves
  B * C * K * 4 bytes a step;
* ``onehot_bf16``: the same with bf16 one-hot and table operands,
  accumulated in float32 (each term is the table entry rounded to bf16);
* ``gather_flat``: one ``torch.gather`` into the flattened (B, M * K)
  table at ``m * K + code``, then a sum over M.

The port's ``ops/pq.py::_pq_score`` (one gather of the (B, M, K) table,
then the M terms added in subspace order) is the reference: each form is
first held to it, the float32 ones at rtol 1e-6 and atol 1e-5 (the sums'
order), bf16 at rtol 2e-2 and atol 2e-1 (the tables' rounding, JAX's
bounds), then timed with ``_pq_score`` itself from dispatch to host
pull, the best of interleaved rounds, at the engine's regime (m 64, 256
centroids, 848 candidates a probe, B = Q * P of 32 and 256).

    python -m art_sbir_tpu_torch.scripts.probe_pq_scoring [--rounds 8]
        [--device cuda|cpu]

``--device cpu`` times on the host clock: those times say nothing of the
card.
"""

from __future__ import annotations

import argparse
import json
import numpy as np
import torch

from art_sbir_tpu_torch.core.device import (card_fields, ieee_f32,
                                            resolve_device)
from art_sbir_tpu_torch.ops.ivf import _generator
from art_sbir_tpu_torch.ops.pq import _pq_score
from art_sbir_tpu_torch.scripts.probe_util import best_ms, log

M, K, C = 64, 256, 848  # the engine's regime: m 64, 256 centroids, Cpad
BATCHES = (32, 256)  # Q * P at coalesced batch 4 and at bucket 32
F32_TOL = dict(rtol=1e-6, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-1)


def onehot_f32(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes (B, C, M) uint8, lut (B, M, K) float32 -> (B, C) float32."""
    ieee_f32()
    k = torch.arange(lut.shape[2], device=lut.device)
    acc = torch.zeros(codes.shape[:2], dtype=torch.float32,
                      device=lut.device)
    for m in range(codes.shape[2]):
        onehot = (codes[:, :, m, None].long() == k).to(torch.float32)
        acc = acc + torch.bmm(onehot, lut[:, m, :, None])[..., 0]
    return acc


def onehot_bf16(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    k = torch.arange(lut.shape[2], device=lut.device)
    lut16 = lut.to(torch.bfloat16)
    acc = torch.zeros(codes.shape[:2], dtype=torch.float32,
                      device=lut.device)
    for m in range(codes.shape[2]):
        onehot = (codes[:, :, m, None].long() == k).to(torch.bfloat16)
        acc = acc + torch.bmm(onehot, lut16[:, m, :, None])[..., 0].float()
    return acc


def gather_flat(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    b, c, m = codes.shape
    k = lut.shape[2]
    idx = (torch.arange(m, device=lut.device) * k)[None, None, :] \
        + codes.long()
    vals = torch.gather(lut.reshape(b, m * k), 1, idx.reshape(b, c * m))
    return vals.reshape(b, c, m).sum(dim=-1)


FORMS = (("onehot_f32", onehot_f32, F32_TOL),
         ("onehot_bf16", onehot_bf16, BF16_TOL),
         ("gather_flat", gather_flat, F32_TOL))


def check_forms(codes: torch.Tensor, lut: torch.Tensor) -> None:
    """Hold each form to ``ops/pq.py::_pq_score`` at its tolerance."""
    ref = _pq_score(codes, lut).cpu().numpy()
    for name, fn, tol in FORMS:
        np.testing.assert_allclose(fn(codes, lut).cpu().numpy(), ref,
                                   err_msg=name, **tol)


def run(rounds: int = 8, device="cuda") -> dict:
    dev = resolve_device(device)
    gen = _generator(3, dev)
    out = {"device": str(dev), **card_fields(dev),
           "clock": "CUDA events" if dev.type == "cuda" else "host",
           "m": M, "k": K, "c": C, "ms": {}}
    for b in BATCHES:
        codes = torch.randint(0, K, (b, C, M), generator=gen, device=dev,
                              dtype=torch.uint8)
        lut = torch.rand((b, M, K), generator=gen, device=dev)
        check_forms(codes, lut)
        forms = [(name, fn) for name, fn, _ in FORMS] + [("pq_score",
                                                          _pq_score)]
        best = best_ms([(name, (lambda fn=fn: fn(codes, lut).cpu().numpy()))
                        for name, fn in forms], rounds, dev)
        base = best["onehot_f32"]
        for name in best:
            log(f"B={b:>3} {name:<12} {best[name]:8.3f} ms "
                f"({base / best[name]:5.2f}x onehot_f32)")
        out["ms"][str(b)] = best
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    res = run(args.rounds, args.device)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
