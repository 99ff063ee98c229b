"""How far ``train_dp``'s pix2pix state moves between two runs of the same
float32 steps on the card, against the rules that hold two ranks to one
process: the element rule that ``probe_dp_cards.failures`` applied
before (rtol 1e-3, atol 5e-5 between the ranks and one process) and its
float64 rule (``probe_dp_cards.state_errors``), which it holds under
cuDNN's deterministic algorithms.

    python -m art_sbir_tpu_torch.scripts.probe_pix2pix_dp_noise
    python -m art_sbir_tpu_torch.scripts.probe_pix2pix_dp_noise --device cpu

The phase's pix2pix batch (the phase's seed, 41, after its 32 triplet
rows; ``chip_smoke.py``'s ``PIX_B`` = 6 at 256 px, the U-Net with
dropout and the basic D at ``ngf`` = ``ndf`` = 64; on the card under
the deterministic algorithms the phase's own readings to the bit),
``probe_dp_cards.pix2pix_steps`` once in float64, then twice in one
process and once on two gloo ranks of the one card, with cuDNN's default
algorithms and with ``torch.backends.cudnn.deterministic``. One JSON
line a mode: each pair's largest excess over the element rule (negative:
within it) and the tensor it falls on, the float64 rule's readings for
the ranks against either one-process run and for the second run against
the first, and each float32 run's largest element distance from float64.
It says whether a rule's margin is the data-parallel split's or the
card's run-to-run noise. ``--device cpu`` rehearses it at ``ngf`` = 8.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch

from art_sbir_tpu_torch.scripts import probe_dp_cards as P

PIX_B = 6
TRAIN_B = 32  # drawn first: the phase's triplet rows


def excess(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
           ) -> Dict:
    """The rule's largest excess of ``got`` over ``want`` and its tensor."""
    value, name = max(
        (float(((got[k].double() - v.double()).abs() - 5e-5
                - 1e-3 * v.double().abs()).max()), k)
        for k, v in want.items() if v.is_floating_point())
    return {"excess": value, "tensor": name}


def max_abs(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
            ) -> Dict:
    value, name = max(
        (float((got[k].double() - v.double()).abs().max()), k)
        for k, v in want.items() if v.is_floating_point())
    return {"max_abs": value, "tensor": name}


def _steps(device, batch: dict, geo: dict, deterministic: bool,
           dtype_name: str = "float32") -> Dict[str, torch.Tensor]:
    return P.pix2pix_steps(batch, geo, device, dtype_name,
                           deterministic)["state"]


def _rank(device, batch: dict, geo: dict, deterministic: bool):
    return _steps(device, batch, geo, deterministic)


def main(argv=None) -> None:
    from art_sbir_tpu_torch.parallel import multihost

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cpu = torch.device(args.device).type == "cpu"
    geo = P.THIN if cpu else P.FULL
    batch = P.make_inputs(np.random.default_rng(41), geo, b=TRAIN_B,
                          pix_b=PIX_B, vae_b=2)["pix"]
    t0 = time.perf_counter()
    f64 = _steps(args.device, batch, geo, True, "float64")
    print(json.dumps({"float64_s": time.perf_counter() - t0}), flush=True)
    for det in (False, True):
        t0 = time.perf_counter()
        a = _steps(args.device, batch, geo, det)
        b = _steps(args.device, batch, geo, det)
        ranks = multihost.spawn(_rank, [args.device] * 2, batch, geo, det)
        print(json.dumps({
            "cudnn_deterministic": det,
            "element_rule": {"one_vs_one": excess(b, a),
                             "ranks_vs_one": excess(ranks, a),
                             "ranks_vs_second_one": excess(ranks, b)},
            "float64_rule": {"ranks": P.state_errors(ranks, a, f64),
                             "ranks_second_one": P.state_errors(ranks, b,
                                                                f64),
                             "second_one": P.state_errors(b, a, f64)},
            "vs_float64": {what: max_abs(run, f64) for what, run in
                           (("one", a), ("second_one", b),
                            ("ranks", ranks))},
            "s": time.perf_counter() - t0}), flush=True)
    if not cpu:
        from art_sbir_tpu_torch.core.device import card_fields
        print(json.dumps(card_fields(args.device)))


if __name__ == "__main__":
    main()
