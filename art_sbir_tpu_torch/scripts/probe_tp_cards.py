"""Tensor-parallel training over distinct cards, and the checks that
``chip_smoke.py``'s ``train_tp`` phase runs on two ranks of one card.

    python -m art_sbir_tpu_torch.scripts.probe_tp_cards
    python -m art_sbir_tpu_torch.scripts.probe_tp_cards --device cpu

On a machine with four cards or more: a 2 data x 2 model grid
(``parallel/tensor.py``) over the first four, NCCL, each part held
against one process on card 0 (``scripts/probe_dp_cards.py``'s step
functions, which make the model tensor parallel inside a grid):

* ``steps``: the flagship ModifiedResNet50 with the 125-class head at
  224 px (global batch 8, float32 with TF32 off, augmentation V1 and the
  paired flip, one Adam step), the pix2pix U-Net with dropout and the basic
  D at ``ngf`` = ``ndf`` = 64, 256 px (global batch 6, two steps) and the
  full-width VAE at 256 px (global batch 8, two steps), by
  :func:`failures`' rules: the triplet's losses and every pix2pix and VAE
  loss no farther from a float64 step than twice the one process's
  float32 distance plus rtol 1e-5 (for the triplet, the widest of three
  float32 runs, its rows in three orders:
  ``probe_dp_cards.row_orders``), the triplet's flat gradient no farther
  from float64's (relative L2) than twice the one process's plus 1e-4,
  augmented rows equal to the one process's, gathered statistics,
  parameters and pix2pix state equal on every rank bit for bit; each
  rank's bytes of parameters, Adam state and buffers (its slices)
  against the one process's;
* ``timing``: float32 triplet steps of the grid (the median wall of
  ``TIMED[1]`` after ``TIMED[0]``), the collectives a step by kind (count,
  bytes of the calls' inputs) and the share of the step spent in their
  calls;
* ``cli``: ``cli/train.py --n_devices 2 --tp_devices 2`` for one float32
  epoch at 128 px and lr 0 against one card (``probe_dp_cards.cli_check``
  with JAX's CLI rule).

One JSON line a part, then each card's name and power limit from
``nvidia-smi``. Any failed check exits non-zero. ``--device cpu``
rehearses the control flow on 4 CPU ranks over gloo at a thin width (its
times are the CPU's).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from art_sbir_tpu_torch.scripts import probe_dp_cards as P

B, PIX_B, VAE_B = 8, 6, 8  # global batches (a model group's)
TIMED = (1, 3)  # warm-up and timed float32 triplet steps
KINDS = ("all_gather", "all_reduce", "broadcast")


def reference(inputs: dict, geo: dict, device, path: Path) -> None:
    """One process's float32 and float64 results of every step into
    ``path``."""
    ref = {}
    for name, fn in (("triplet", P.triplet_steps), ("pix2pix",
                                                    P.pix2pix_steps),
                     ("vae", P.vae_steps)):
        arg = inputs[{"triplet": "u8", "pix2pix": "pix", "vae": "vae"}[name]]
        for dtype, key in (("float32", name), ("float64", f"{name}_f64")):
            kw = {"steps": 1} if name == "triplet" else {}
            P._empty(device)
            ref[key] = fn(arg, geo, device, dtype, **kw)
    ref["triplet_orders"] = []
    for order in P.row_orders(len(inputs["u8"]["label"])):
        P._empty(device)
        ref["triplet_orders"].append(P.triplet_steps(
            inputs["u8"], geo, device, steps=1, order=order)["losses"])
    torch.save(ref, path)
    P._empty(device)


@contextlib.contextmanager
def counted():
    """Count the calls of ``torch.distributed``'s collectives inside the
    block: ``calls[kind]`` = [count, bytes of the inputs], ``calls['s']``
    the wall of the calls (gloo's wait for the data, NCCL's enqueue)."""
    calls = {k: [0, 0] for k in KINDS}
    calls["s"] = 0.0
    plain = {k: getattr(dist, k) for k in KINDS}

    def wrap(kind):
        def call(*a, **k):
            t = a[1] if kind == "all_gather" else a[0]
            t0 = time.perf_counter()
            out = plain[kind](*a, **k)
            calls["s"] += time.perf_counter() - t0
            calls[kind][0] += 1
            calls[kind][1] += t.numel() * t.element_size()
            return out
        return call

    for k in KINDS:
        setattr(dist, k, wrap(k))
    try:
        yield calls
    finally:
        for k in KINDS:
            setattr(dist, k, plain[k])


def timed_steps(u8: dict, geo: dict, device, timed=TIMED) -> Dict:
    """Float32 triplet steps of this rank (tensor parallel in a grid): the
    median wall, the collectives of a step and their calls' share."""
    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.parallel import multihost
    from art_sbir_tpu_torch.parallel.tensor import (model_shard,
                                                    tensor_parallel)
    from art_sbir_tpu_torch.train.prepare import finish_triplet_batch
    from art_sbir_tpu_torch.train.triplet import create_train_state

    ieee_f32()
    model = tensor_parallel(P._encoder(geo, device, torch.float32),
                            model_shard())
    state = create_train_state(model)
    step = P._step_fn()
    sl = multihost.process_shard(len(u8["label"]))
    batch = finish_triplet_batch({k: torch.from_numpy(v[sl]).to(device)
                                  for k, v in u8.items()}, train=True)
    times, shares, last = [], [], None
    for _ in range(sum(timed)):
        with counted() as calls:
            P._sync(device)
            t0 = time.perf_counter()
            step(state, batch)
            P._sync(device)
            wall = time.perf_counter() - t0
        times.append(1e3 * wall)
        shares.append(calls["s"] / wall)
        last = calls
    w = timed[0]
    return {"rows": sl.stop - sl.start, "step_ms": times[w:],
            "step_ms_median": float(np.median(times[w:])),
            "collective_share_median": float(np.median(shares[w:])),
            "collectives_a_step": {k: {"count": last[k][0],
                                       "bytes": last[k][1]} for k in KINDS}}


def _loss_errors(got: List[dict], one: List[dict], f64: List[dict],
                 others: List[List[dict]] = ()) -> List[dict]:
    """Each loss of each step; ``rel_one_vs_f64`` is the widest of the one
    process's float32 runs (``one`` and the ``others``, the triplet's in
    other row orders) from float64."""
    return [{"step": s + 1, "loss": k, "ranks": got[s][k], "one": v,
             "f64": f64[s][k], "rel_ranks_vs_f64": P._rel(got[s][k],
                                                          f64[s][k]),
             "rel_one_vs_f64": P.widest_rel([one, *others], f64, s, k)}
            for s in range(len(one)) for k, v in one[s].items()]


def _held(got: Dict, one: Dict) -> Dict:
    return {"rank": got, "one_process": one,
            "share": {k: got[k] / max(one[k], 1) for k in got}}


def rank_checks(device, inputs: dict, geo: dict, ref_path: str,
                timed=TIMED) -> Dict:
    """Every step on this rank of the grid against the one process's
    results in ``ref_path``; the readings (rank 0's are returned by
    ``spawn``)."""
    from art_sbir_tpu_torch.parallel import multihost

    ref = torch.load(ref_path, weights_only=False)
    g = multihost.grid()
    r = multihost.data_rank()
    out = {"rank": multihost.rank(), "world": multihost.world_size(),
           "grid": [g.n_data, g.n_model], "device": str(device),
           "backend": dist.get_backend()}
    t0 = time.perf_counter()
    got = P.triplet_steps(inputs["u8"], geo, device, steps=1)
    one, f64 = ref["triplet"], ref["triplet_f64"]
    out["triplet"] = {
        "loss_errors": _loss_errors(got["losses"], one["losses"],
                                    f64["losses"], ref["triplet_orders"]),
        "gradient": P._gradient_errors(one["grads"][0], got["grads"][0],
                                       f64["grads"][0], one["grad_names"]),
        "sketch_rows_equal": all(
            torch.equal(a, b[r * a.shape[0]:(r + 1) * a.shape[0]])
            for a, b in zip(got["sketch"], one["sketch"])),
        "stats_equal_on_ranks": P.same_on_ranks(got["stats"], device),
        "params_equal_on_ranks": P.same_on_ranks(got["params"], device),
        "stats_rel_vs_one": float((got["stats"] - one["stats"]).norm()
                                  / one["stats"].norm()),
        "held_bytes": _held(got["held"], one["held"]),
        "s": time.perf_counter() - t0}
    del got
    P._empty(device)

    for name, fn, batch in (("pix2pix", P.pix2pix_steps, inputs["pix"]),
                            ("vae", P.vae_steps, inputs["vae"])):
        t0 = time.perf_counter()
        got = fn(batch, geo, device)
        one, f64 = ref[name], ref[f"{name}_f64"]
        out[name] = {"loss_errors": _loss_errors(
            got["losses"], one["losses"], f64["losses"]),
            "s": time.perf_counter() - t0}
        if name == "pix2pix":
            out[name]["state_equal_on_ranks"] = all(
                [P.same_on_ranks(v, device) for v in got["state"].values()])
            out[name]["held_bytes"] = {
                n: _held(got["held"][n], one["held"][n]) for n in ("g", "d")}
        else:
            out[name]["held_bytes"] = _held(got["held"], one["held"])
            out[name]["grad_norm_rel_vs_one"] = P._rel(got["grad_norm"],
                                                       one["grad_norm"])
        del got
        P._empty(device)
    t0 = time.perf_counter()
    out["timing"] = timed_steps(inputs["u8"], geo, device, timed)
    out["timing"]["s"] = time.perf_counter() - t0
    return out


def failures(d: Dict) -> List[str]:
    """The broken rules of :func:`rank_checks`' readings."""
    bad = []
    for what in ("triplet", "pix2pix", "vae"):
        for e in d[what]["loss_errors"]:
            if e["rel_ranks_vs_f64"] > 2 * e["rel_one_vs_f64"] + 1e-5:
                bad.append(f"{what} step {e['step']} {e['loss']}: ranks "
                           f"{e['ranks']} lie {e['rel_ranks_vs_f64']:.3g} "
                           f"from float64 {e['f64']}, one process "
                           f"{e['rel_one_vs_f64']:.3g}")
    tri = d["triplet"]
    g = tri["gradient"]
    if g["rel_l2_ranks_vs_f64"] > 2 * g["rel_l2_one_vs_f64"] + 1e-4:
        bad.append(f"triplet step 1: gradient {g}")
    for k in ("sketch_rows_equal", "stats_equal_on_ranks",
              "params_equal_on_ranks"):
        if not tri[k]:
            bad.append(f"triplet: not {k}")
    if not d["pix2pix"]["state_equal_on_ranks"]:
        bad.append("pix2pix: state differs between ranks")
    helds = [tri["held_bytes"], d["vae"]["held_bytes"],
             *d["pix2pix"]["held_bytes"].values()]
    for h in helds:
        if (h["rank"]["parameters"] >= h["one_process"]["parameters"]
                or any(h["rank"][k] > h["one_process"][k]
                       for k in h["rank"])):
            bad.append(f"a rank holds more than its slices: {h}")
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="'cpu' rehearses on 4 CPU ranks at a thin width")
    args = p.parse_args(argv)
    from art_sbir_tpu_torch.parallel import multihost
    from art_sbir_tpu_torch.parallel.mesh import data_mesh

    cpu = args.device == "cpu"
    geo = P.THIN if cpu else P.FULL
    devices = (["cpu"] * 4 if cpu
               else [str(d) for d in data_mesh(-1).devices][:4])
    if len(devices) < 4:
        raise SystemExit("probe_tp_cards: needs 4 cards")
    bad = []
    inputs = P.make_inputs(np.random.default_rng(43), geo, b=B, pix_b=PIX_B,
                           vae_b=VAE_B)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        reference(inputs, geo, devices[0], tmp / "ref.pt")
        ranks = multihost.spawn(rank_checks, devices, inputs, geo,
                                str(tmp / "ref.pt"), n_model=2)
        bad += failures(ranks)
        print(json.dumps({"part": "steps", "devices": devices,
                          **{k: ranks[k] for k in ("grid", "backend",
                                                   "triplet", "pix2pix",
                                                   "vae")},
                          "s": time.perf_counter() - t0}), flush=True)
        print(json.dumps({"part": "timing", **ranks["timing"]}), flush=True)
        from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy

        root = make_synthetic_sketchy(
            tmp / "sketchy", n_classes=25, photos_per_class=18,
            sketches_per_photo=4, size=geo["cli_res"], learnable=True)
        cli = P.cli_check(tmp, root, devices, geo, dsize=0.1, tp=2)
        bad += cli["failures"]
        print(json.dumps({"part": "cli", **cli}), flush=True)
    if not cpu:
        print("\n".join(P.card_lines()), flush=True)
    if bad:
        print("probe_tp_cards: FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
