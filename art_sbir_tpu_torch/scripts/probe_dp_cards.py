"""Data-parallel training over distinct cards, and the checks that
``chip_smoke.py``'s ``train_dp`` phase runs on two ranks of one card.

    python -m art_sbir_tpu_torch.scripts.probe_dp_cards
    python -m art_sbir_tpu_torch.scripts.probe_dp_cards --device cpu

On a machine with several cards, one rank a card over every card present
(at least 2; NCCL), each part held against one process on card 0:

* ``steps``: the flagship ModifiedResNet50 with the 125-class head
  (global batch 32, float32 with TF32 off, augmentation V1 and the paired
  flip on, two Adam steps at lr 1e-5, the second taken by every run from
  the float64 run's state after the first), the pix2pix U-Net with
  dropout and the basic D at ``ngf`` = ``ndf`` = 64, 256 px (global batch
  8), and the full-width VAE (global batch 64), by :func:`failures`'
  rules: the triplet's losses no farther from a float64 step than twice
  the one process's float32 distance plus rtol 1e-5, the first step's
  flat gradient and parameter update no farther from float64's
  (relative L2) than twice the one process's plus 1e-4 (the second
  step's gradient is reported), augmented rows, running statistics and
  reduced gradients equal bit for bit; pix2pix's and the VAE's losses at
  rel 1e-5 (absolute 1e-6), pix2pix's parameters at rtol 1e-3, atol
  5e-5.
  JAX's own rule between two float32 gradients (relative L2 below
  1e-2, cosine above 0.9999, ``tests/test_sharding.py:62-71``), which
  the CPU tests hold, cannot hold here: at B = 32 and 224 px one
  float32 process's gradient lies 1.76e-2 from float64, with or without
  cuDNN (the stem's and layer 1's conv weight gradients, sums of
  400,000 terms that BatchNorm's backward makes cancel);
* ``bf16``: the bf16 triplet step's median at B = 32 on one card and at
  32 a card on every card, with the all-reduces a step (count, bytes)
  and a standalone all-reduce of the gradient buffer;
* ``cli``: ``cli/train.py --n_devices N`` for one float32 epoch at 128 px
  (a tenth of ``chip_smoke.py``'s training corpus, batch 32) against one
  card, JAX's CLI rule (losses rtol 2e-3, ``topk_acc`` equal, MRR rtol
  1e-6);
* ``gallery``: ``run_inference`` and ``RetrievalEngine`` with a gallery
  mesh over the distinct cards against one card: the same ranks, MRR
  and top-k.

One JSON line a part, then each card's name and power limit from
``nvidia-smi``. Any failed check exits non-zero. ``--device cpu``
rehearses the control flow on 4 CPU ranks over gloo at a thin width (its
times are the CPU's).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

FULL = dict(width=64, layers=(3, 4, 6, 3), res=224, pix_ngf=64,
            vae={}, vae_res=256, cli_res=128, cli_width=64,
            cli_layers=(3, 4, 6, 3))
THIN = dict(width=8, layers=(1, 1, 1, 1), res=64, pix_ngf=8,
            vae=dict(z_size=8, dec_rnn_size=16, num_mixture=3), vae_res=64,
            cli_res=64, cli_width=8, cli_layers=(1, 1, 1, 1))
STEPS = 2
TIMED = (3, 10)  # warm-up and timed bf16 steps


def sketches(rng, b: int) -> np.ndarray:
    """(b, 100, 5) padded stroke-5 sketches: N(0, 1) deltas, a pen lift
    about one row in seven, an end token after 20 to 99 rows."""
    out = np.zeros((b, 100, 5), np.float32)
    for i in range(b):
        n = int(rng.integers(20, 100))
        out[i, :n, :2] = rng.standard_normal((n, 2))
        up = rng.random(n) < 0.15
        out[i, :n, 3] = up
        out[i, :n, 2] = ~up
        out[i, n - 1:, 2:] = [0, 0, 1]
    return out


def make_inputs(rng, geo: dict, b: int = 32, pix_b: int = 8,
                vae_b: int = 64) -> dict:
    """The global batches of the three steps, from ``rng``."""
    r = geo["res"]
    u8 = {k: rng.integers(0, 256, (b, r, r, 3), dtype=np.uint8)
          for k in ("sketch", "positive", "negative")}
    u8["label"] = rng.integers(0, 125, b).astype(np.int32)
    v = geo["vae_res"]
    return {"u8": u8, "pix": {
        "A": rng.random((pix_b, 3, 256, 256)).astype(np.float32),
        "B": rng.random((pix_b, 1, 256, 256)).astype(np.float32)},
        "vae": {"photo": rng.standard_normal((vae_b, 3, v, v)).astype(
            np.float32), "sketch_vector": sketches(rng, vae_b)}}


def _whole(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``t`` (``p``'s gradient or a tensor of its shape) in one device's
    layout: gathered over the model group where ``p`` is a tensor-parallel
    slice (``parallel/tensor.py``), else ``t``."""
    from art_sbir_tpu_torch.parallel.tensor import model_shard

    dim = getattr(p, "tp_dim", None)
    return t if dim is None else model_shard().all_gather(t, dim)


def _recording_adam(params, **kw):
    """torch's Adam that keeps each step's (reduced) gradient, flat on the
    CPU, in one device's layout."""

    class Recording(torch.optim.Adam):
        def step(self, closure=None):
            self.seen.append(torch.cat([
                _whole(p.grad.detach(), p).reshape(-1).float().cpu()
                for g in self.param_groups for p in g["params"]
                if p.grad is not None]))
            return super().step(closure)

    opt = Recording(params, **kw)
    opt.seen = []
    return opt


def _encoder(geo: dict, device, dtype=torch.bfloat16):
    from art_sbir_tpu_torch.models.resnet import create_encoder

    return create_encoder(with_classification=True, num_classes=125,
                          compute_dtype=dtype, device=device, seed=1,
                          width=geo["width"], layers=geo["layers"],
                          input_resolution=geo["res"])


def _step_fn():
    from art_sbir_tpu_torch.train.losses import TripletLossConfig
    from art_sbir_tpu_torch.train.triplet import make_train_step

    return make_train_step(TripletLossConfig.for_dataset(
        "SketchyDatasetV2", "euclidean", True))


def triplet_steps(u8: dict, geo: dict, device,
                  dtype_name: str = "float32", steps: int = STEPS,
                  restart: Dict | None = None) -> Dict:
    """``steps`` Adam steps (lr 1e-5, the CLI's) on this rank's rows of the
    uint8 triplet ``u8`` (all of them outside a group), augmented from a
    seeded generator on ``device``: the losses, each step's gradient, the
    finished sketches and the running statistics, on the CPU (in one
    device's layout; in a grid the model is tensor parallel), and after
    the first of several steps its parameter update (``update``) and the
    model's state (``state_1``, whole).

    ``restart`` (a ``state_1``; outside a grid) is loaded before the
    second step, so that runs compared there start it from one point:
    Adam's first step is sign-like, and where a gradient element is
    float32 rounding noise it moves each run by +-lr its own way, which
    the second step's losses would otherwise carry."""
    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.parallel import multihost
    from art_sbir_tpu_torch.parallel.tensor import (gather_state,
                                                    held_bytes, model_shard,
                                                    tensor_parallel)
    from art_sbir_tpu_torch.train.prepare import finish_triplet_batch
    from art_sbir_tpu_torch.train.triplet import TrainState

    ieee_f32()
    dtype = getattr(torch, dtype_name)
    model = tensor_parallel(_encoder(geo, device, dtype).to(dtype),
                            model_shard())
    state = TrainState(model, _recording_adam(model.parameters(), lr=1e-5,
                                              weight_decay=2e-3))
    step = _step_fn()
    n = len(u8["label"])
    sl = multihost.process_shard(n)
    rows = (sl.start, n) if multihost.is_parallel() else None
    gen = torch.Generator(device).manual_seed(7)
    out = {"losses": [], "sketch": []}

    def flat(state):
        return torch.cat([state[k].detach().reshape(-1).cpu().double()
                          for k, _ in model.named_parameters()])

    start = flat(gather_state(model)) if steps > 1 else None
    for s in range(steps):
        if s == 1:
            out["state_1"] = {k: v.detach().to("cpu", copy=True)
                              for k, v in gather_state(model).items()}
            out["update"] = flat(out["state_1"]) - start
            if restart is not None:
                model.load_state_dict(restart)
        batch = finish_triplet_batch(
            {k: torch.from_numpy(v[sl]).to(device) for k, v in u8.items()},
            gen, augment_version=1, flip=True, train=True, rows=rows)
        out["sketch"].append(batch["sketch"].cpu())
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in batch.items()}
        out["losses"].append({k: float(v) for k, v in
                              step(state, batch).items()})
    out["grads"] = state.optimizer.seen
    out["grad_names"] = [(k, _whole(p.detach(), p).numel())
                         for k, p in model.named_parameters()
                         if p.grad is not None]
    out["param_names"] = [(k, _whole(p.detach(), p).numel())
                          for k, p in model.named_parameters()]
    whole = gather_state(model)
    out["stats"] = torch.cat([v.detach().reshape(-1).cpu().double()
                              for k, v in whole.items() if "running_" in k])
    if model_shard() is not None:  # the slices, gathered, for the grid
        out["params"] = torch.cat([whole[k].detach().reshape(-1).cpu()
                                   for k, _ in model.named_parameters()])
    out["held"] = held_bytes(model, state.optimizer)
    return out


def pix2pix_steps(batch: dict, geo: dict, device,
                  dtype_name: str = "float32") -> Dict:
    """STEPS G+D steps (float32, or ``dtype_name``) of the U-Net (dropout
    on) and the basic D on this rank's rows: the losses and both nets'
    state on the CPU (in one device's layout; tensor parallel in a
    grid)."""
    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.parallel.mesh import shard_or_replicate
    from art_sbir_tpu_torch.parallel.tensor import (gather_state,
                                                    held_bytes, model_shard)
    from art_sbir_tpu_torch.train.gan import Pix2Pix, Pix2PixConfig

    ieee_f32()
    m = Pix2Pix(Pix2PixConfig(net_g="unet_256", ngf=geo["pix_ngf"],
                              ndf=geo["pix_ngf"]), seed=0, device=device)
    if dtype_name != "float32":
        m.net_g.to(getattr(torch, dtype_name))
        m.net_d.to(getattr(torch, dtype_name))
        m._optimizers()
    m.tensor_parallel(model_shard())
    local, rows = shard_or_replicate({k: torch.from_numpy(v).to(device)
                                      for k, v in batch.items()})
    losses = [{k: float(v) for k, v in
               m.train_step(local, seed, rows=rows).items()}
              for seed in range(1, STEPS + 1)]
    return {"losses": losses, "state": {
        f"{n}.{k}": v.detach().cpu() for n, net in (("g", m.net_g),
                                                    ("d", m.net_d))
        for k, v in gather_state(net).items()},
        "held": {n: held_bytes(net, opt) for n, net, opt in (
            ("g", m.net_g, m.opt_g), ("d", m.net_d, m.opt_d))}}


def vae_steps(batch: dict, geo: dict, device,
              dtype_name: str = "float32") -> Dict:
    """STEPS VAE steps (float32, or ``dtype_name``) on this rank's rows:
    losses, clip norm (tensor parallel in a grid)."""
    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.parallel.mesh import shard_or_replicate
    from art_sbir_tpu_torch.parallel.tensor import held_bytes, model_shard
    from art_sbir_tpu_torch.train.vae import VAEConfig, VAETrainer

    ieee_f32()
    t = VAETrainer(VAEConfig(**geo["vae"]), seed=0, device=device)
    t.model.to(getattr(torch, dtype_name))
    t.tensor_parallel(model_shard())
    losses = []
    for seed in range(1, STEPS + 1):
        local, rows = shard_or_replicate({k: torch.from_numpy(v).to(device)
                                          for k, v in batch.items()})
        losses.append({k: float(v) for k, v in
                       t.train_step(local, seed, rows).items()})
    return {"losses": losses, "grad_norm": float(t.grad_norm),
            "held": held_bytes(t.model, t.optimizer)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bf16_step_ms(u8: dict, geo: dict, device, timed=TIMED) -> Dict:
    """The bf16 triplet step on this rank's rows of ``u8``: the median wall
    of ``timed[1]`` steps after ``timed[0]`` (each waited for), the
    all-reduces a
    step (count, bytes, and the wall of the calls: gloo's wait for the
    data, NCCL's only the enqueue), and, in a group, a standalone
    all-reduce of the gradient buffer."""
    from art_sbir_tpu_torch.parallel import multihost
    from art_sbir_tpu_torch.train.prepare import finish_triplet_batch
    from art_sbir_tpu_torch.train.triplet import create_train_state

    model = _encoder(geo, device)
    state = create_train_state(model)
    step = _step_fn()
    sl = multihost.process_shard(len(u8["label"]))
    batch = finish_triplet_batch({k: torch.from_numpy(v[sl]).to(device)
                                  for k, v in u8.items()}, train=True)
    calls = {"n": 0, "s": 0.0, "bytes": 0}
    plain = dist.all_reduce

    def counted(tensor, *a, **k):
        t0 = time.perf_counter()
        work = plain(tensor, *a, **k)
        calls["s"] += time.perf_counter() - t0
        calls["n"] += 1
        calls["bytes"] += tensor.numel() * tensor.element_size()
        return work

    times, reduce_ms = [], []
    dist.all_reduce = counted
    try:
        for _ in range(sum(timed)):
            calls.update(n=0, s=0.0, bytes=0)
            _sync(device)
            t0 = time.perf_counter()
            step(state, batch)
            _sync(device)
            times.append(1e3 * (time.perf_counter() - t0))
            reduce_ms.append(1e3 * calls["s"])
    finally:
        dist.all_reduce = plain
    w = timed[0]
    out = {"rows": sl.stop - sl.start,
           "step_ms_median": float(np.median(times[w:])),
           "step_ms": times[w:],
           "all_reduce_call_ms_median": float(np.median(reduce_ms[w:])),
           "all_reduces_a_step": calls["n"],
           "all_reduce_bytes_a_step": calls["bytes"]}
    if multihost.is_parallel():
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        ms = []
        for _ in range(5):
            dist.barrier()
            _sync(device)
            t0 = time.perf_counter()
            dist.all_reduce(flat)
            _sync(device)
            ms.append(1e3 * (time.perf_counter() - t0))
        out["grad_buffer_bytes"] = flat.numel() * flat.element_size()
        out["grad_all_reduce_ms_median"] = float(np.median(ms[1:]))
    return out


def same_on_ranks(t: torch.Tensor, device) -> bool:
    """Whether the CPU tensor ``t`` is rank 0's bit for bit on every rank:
    its bytes' SHA-256 is broadcast from rank 0 (on ``device``: NCCL
    moves no CPU tensor) and compared."""
    digest = hashlib.sha256(t.contiguous().numpy().tobytes()).digest()
    mine = torch.tensor(list(digest), dtype=torch.int32, device=device)
    theirs = mine.clone()
    dist.broadcast(theirs, src=0)
    differ = (theirs != mine).any().to(torch.float32).reshape(1)
    dist.all_reduce(differ)
    return float(differ) == 0.0


def _gradient_errors(one: torch.Tensor, ranks: torch.Tensor,
                     exact: torch.Tensor, names) -> Dict:
    """The ranks' flat gradient against the one process's (JAX's rule:
    relative L2 and cosine), both against float64, and the three tensors
    where the ranks and the one process differ most (each error relative
    to the tensor's float64 norm)."""
    one, ranks, exact = one.double(), ranks.double(), exact.double()
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    worst, o = [], 0
    for name, n in names:
        a, b, e = one[o:o + n], ranks[o:o + n], exact[o:o + n]
        o += n
        scale = max(float(e.norm()), 1e-30)
        worst.append((float((b - a).norm()) / scale, name,
                      float((a - e).norm()) / scale,
                      float((b - e).norm()) / scale))
    worst.sort(reverse=True)
    return {"rel_l2": rel(ranks, one),
            "cos": float(one @ ranks / (one.norm() * ranks.norm())),
            "rel_l2_one_vs_f64": rel(one, exact),
            "rel_l2_ranks_vs_f64": rel(ranks, exact),
            "worst": [{"tensor": w[1], "ranks_vs_one": w[0],
                       "one_vs_f64": w[2], "ranks_vs_f64": w[3]}
                      for w in worst[:3]]}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def reference(inputs: dict, geo: dict, device, path: Path) -> Dict:
    """The one-process results of every step into ``path`` (float32, and
    the triplet in float64 too); returns the one-process bf16 timing."""
    ref = {"triplet_f64": triplet_steps(inputs["u8"], geo, device,
                                        "float64")}
    _empty(device)
    restart = ref["triplet_f64"]["state_1"]
    for key, fn in (("triplet", lambda: triplet_steps(
            inputs["u8"], geo, device, restart=restart)),
                    ("pix2pix", lambda: pix2pix_steps(inputs["pix"], geo,
                                                      device)),
                    ("vae", lambda: vae_steps(inputs["vae"], geo, device))):
        _empty(device)
        ref[key] = fn()
    torch.save(ref, path)
    del ref
    _empty(device)
    return bf16_step_ms(inputs["u8_timing"], geo, device)


def _empty(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def rank_checks(device, inputs: dict, geo: dict, ref_path: str,
                timed=TIMED) -> Dict:
    """Every step on this rank against the one process's results in
    ``ref_path``; the readings (rank 0's are returned by ``spawn``)."""
    from art_sbir_tpu_torch.parallel import multihost

    ref = torch.load(ref_path, weights_only=False)
    r = multihost.data_rank()
    out = {"rank": r, "world": multihost.world_size(),
           "device": str(device), "backend": dist.get_backend()}
    t0 = time.perf_counter()
    one, f64 = ref["triplet"], ref["triplet_f64"]
    got = triplet_steps(inputs["u8"], geo, device, restart=f64["state_1"])
    out["triplet"] = {
        "loss_errors": [
            {"step": s + 1, "loss": k, "ranks": got["losses"][s][k],
             "one": want, "f64": f64["losses"][s][k],
             "rel_ranks_vs_one": _rel(got["losses"][s][k], want),
             "rel_ranks_vs_f64": _rel(got["losses"][s][k],
                                      f64["losses"][s][k]),
             "rel_one_vs_f64": _rel(want, f64["losses"][s][k])}
            for s in range(STEPS) for k, want in one["losses"][s].items()],
        "gradient": [_gradient_errors(g1, g2, g64, one["grad_names"])
                     for g1, g2, g64 in zip(one["grads"], got["grads"],
                                            f64["grads"])],
        "update": _gradient_errors(one["update"], got["update"],
                                   f64["update"], one["param_names"]),
        "sketch_rows_equal": all(
            torch.equal(a, b[r * a.shape[0]:(r + 1) * a.shape[0]])
            for a, b in zip(got["sketch"], one["sketch"])),
        "stats_equal_on_ranks": same_on_ranks(got["stats"], device),
        "grads_equal_on_ranks": all([same_on_ranks(g, device)
                                     for g in got["grads"]]),
        "stats_rel_vs_one": float((got["stats"] - one["stats"]).norm()
                                  / one["stats"].norm()),
        "s": time.perf_counter() - t0}
    del got
    _empty(device)

    t0 = time.perf_counter()
    got = pix2pix_steps(inputs["pix"], geo, device)
    excess, worst = max(
        (float(((got["state"][k].double() - v.double()).abs() - 5e-5
                - 1e-3 * v.double().abs()).max()), k)
        for k, v in ref["pix2pix"]["state"].items() if v.is_floating_point())
    out["pix2pix"] = {
        "losses": got["losses"], "losses_one": ref["pix2pix"]["losses"],
        "param_excess_over_bound": excess, "worst_tensor": worst,
        "state_equal_on_ranks": all([same_on_ranks(v, device)
                                     for v in got["state"].values()]),
        "s": time.perf_counter() - t0}
    del got
    _empty(device)

    t0 = time.perf_counter()
    got = vae_steps(inputs["vae"], geo, device)
    out["vae"] = {"losses": got["losses"], "losses_one": ref["vae"]["losses"],
                  "grad_norm_rel": _rel(got["grad_norm"],
                                        ref["vae"]["grad_norm"]),
                  "s": time.perf_counter() - t0}
    _empty(device)
    out["bf16"] = bf16_step_ms(inputs["u8_timing"], geo, device, timed)
    return out


def failures(d: Dict) -> List[str]:
    """The broken rules of :func:`rank_checks`' readings."""
    bad = []
    tri = d["triplet"]
    for e in tri["loss_errors"]:
        if e["rel_ranks_vs_f64"] > 2 * e["rel_one_vs_f64"] + 1e-5:
            bad.append(f"triplet step {e['step']} {e['loss']}: ranks "
                       f"{e['ranks']} lie {e['rel_ranks_vs_f64']:.3g} from "
                       f"float64 {e['f64']}, one process "
                       f"{e['rel_one_vs_f64']:.3g}")
    # the first step's gradient and update; the second step's gradient
    # is reported: from the one restart point the one process's lay 5e-6
    # from float64 on the CPU's 4 ranks, the ranks' 6e-3, within the
    # 3e-3 of a first step's float32 noise (twice a distance that small
    # holds no float32 run)
    for what, g in (("step 1 gradient", tri["gradient"][0]),
                    ("step 1 update", tri["update"])):
        if g["rel_l2_ranks_vs_f64"] > 2 * g["rel_l2_one_vs_f64"] + 1e-4:
            bad.append(f"triplet {what}: {g}")
    for k in ("sketch_rows_equal", "stats_equal_on_ranks",
              "grads_equal_on_ranks"):
        if not tri[k]:
            bad.append(f"triplet: not {k}")
    for what in ("pix2pix", "vae"):
        for s, (got, want) in enumerate(zip(d[what]["losses"],
                                            d[what]["losses_one"])):
            off = {k: (got[k], v) for k, v in want.items()
                   if abs(got[k] - v) > 1e-5 * abs(v) + 1e-6}
            if off:
                bad.append(f"{what} step {s + 1}: losses (rel 1e-5, abs "
                           f"1e-6): {off}")
    pix = d["pix2pix"]
    if pix["param_excess_over_bound"] > 0:
        bad.append(f"pix2pix parameters past rtol 1e-3, atol 5e-5: "
                   f"{pix['worst_tensor']} by {pix['param_excess_over_bound']}")
    if not pix["state_equal_on_ranks"]:
        bad.append("pix2pix: state differs between ranks")
    return bad


def cli_check(tmp: Path, root: Path, devices, geo: dict,
              dsize: float, batch: int = 32, tp: int = 1) -> Dict:
    """``cli/train.py`` for one float32 epoch with ``--inference`` at
    learning rate 0 on the ranks of ``devices`` (``main(argv,
    mesh=...)``) and on ``devices[0]`` alone; JAX's CLI rule between
    them under ``failures``. Every step still runs (the sharded loader,
    the synchronized BatchNorm and its running statistics, backward,
    the gradient all-reduce, Adam); at lr 1e-5 Adam's sign-like first
    steps turn the full-width float32 gradient's own noise (1.8e-2 of
    its norm from float64, one process or two) into losses 0.8% apart
    within five steps (the repo's CLI parity tests run at ``-l 0`` for
    the same reason). ``tp`` > 1: the ranks are a ``(len(devices) / tp,
    tp)`` grid (``--tp_devices``' mesh, ``tensor.mesh_2d``)."""
    from art_sbir_tpu_torch.cli import train
    from art_sbir_tpu_torch.parallel.mesh import MeshSpec
    from art_sbir_tpu_torch.parallel.tensor import mesh_2d

    argv = ["-e", 1, "-b", batch, "-l", 0, "-d", "SketchyV2", "-s", dsize,
            "--model_type", "ModifiedResNet_with_classification",
            "--image_size", geo["cli_res"], "--width", geo["cli_width"],
            "--layers", *geo["cli_layers"], "--no-bf16", "--inference",
            "--data_root", root, "--results_root", "results"]
    runs = {}
    cwd = os.getcwd()
    for n in (1, len(devices)):
        (tmp / f"cli_{n}").mkdir()
        os.chdir(tmp / f"cli_{n}")
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                folder = train.main(
                    [str(a) for a in argv]
                    + ["--device", str(torch.device(devices[0]).type)],
                    mesh=(mesh_2d(n // tp, tp, list(devices))
                          if n > 1 and tp > 1
                          else MeshSpec(n).build(list(devices[:n]))))
        finally:
            os.chdir(cwd)
        folder = tmp / f"cli_{n}" / folder
        runs[n] = {name: json.loads((folder / f"{name}.json").read_text())
                   for name in ("training", "inference", "training_params")}
        runs[n]["s"] = time.perf_counter() - t0
    one, many = runs[1], runs[len(devices)]
    loss_rel = {k: max(_rel(a, b) for a, b in zip(many["training"][k],
                                                   one["training"][k]))
                for k in ("train_losses", "test_losses")}
    mrr = [r["inference"]["mean_reciprocal_rank"] for r in (one, many)]
    bad = [f"{k} at rtol {v:.3g} > 2e-3" for k, v in loss_rel.items()
           if v > 2e-3]
    if many["inference"]["topk_acc"] != one["inference"]["topk_acc"]:
        bad.append("topk_acc differs")
    if _rel(mrr[1], mrr[0]) > 1e-6:
        bad.append(f"MRR {mrr}")
    if many["training_params"]["n_devices"] != len(devices):
        bad.append("training_params.json lacks the ranks")
    return {"loss_rel": loss_rel, "mrr": mrr,
            "top1": one["inference"]["topk_acc"][0],
            "steps": [r["training"]["steps"] for r in (one, many)],
            "mean_step_s": [r["training"]["mean_step_time"]
                            for r in (one, many)],
            "wall_s": [one["s"], many["s"]], "failures": bad}


def gallery_check(tmp: Path, devices, geo: dict) -> Dict:
    """``run_inference`` and ``RetrievalEngine`` with a gallery mesh over
    ``devices`` (a shard each; an encoder replica on each distinct one)
    against ``devices[0]`` alone, from one seeded encoder (bf16) on a
    synthetic Sketchy corpus."""
    import copy

    from art_sbir_tpu_torch.data import get_datasets
    from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy
    from art_sbir_tpu_torch.parallel.mesh import MeshSpec
    from art_sbir_tpu_torch.retrieval.engine import run_inference
    from art_sbir_tpu_torch.retrieval.server import RetrievalEngine
    from art_sbir_tpu_torch.train.prepare import finish_gallery_batch

    distinct = list(dict.fromkeys(torch.device(d) for d in devices))
    mesh = MeshSpec(len(devices)).build(devices)
    root = make_synthetic_sketchy(tmp / "gallery", n_classes=8,
                                  photos_per_class=16, sketches_per_photo=2,
                                  size=geo["cli_res"])
    _, test = get_datasets("SketchyV1", root=root)
    model = _encoder(dict(geo, res=geo["cli_res"], width=geo["cli_width"],
                          layers=geo["cli_layers"]), distinct[0]).eval()
    replicas = {d: model if d == distinct[0] else copy.deepcopy(model).to(d)
                for d in distinct}

    @torch.no_grad()
    def forward(u8):
        out = replicas[u8.device](finish_gallery_batch(u8))
        return out[0] if isinstance(out, tuple) else out

    res = {}
    for tag, m in (("one", None), ("mesh", mesh)):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            d = run_inference(forward, test, None, "euclidean",
                              image_size=geo["cli_res"],
                              save_features=False, device=distinct[0],
                              mesh=m)
        res[tag] = {"topk_acc": d["topk_acc"],
                    "mrr": d["mean_reciprocal_rank"],
                    "s": time.perf_counter() - t0}
    n = 64 * len(devices)
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((n, 1024)).astype(
        np.float32))
    paths = [f"gallery/{i}.jpg" for i in range(n)]
    queries = rng.integers(0, 256, (8, geo["cli_res"], geo["cli_res"], 3),
                           dtype=np.uint8)
    engines = [RetrievalEngine(forward, feats, paths, device=distinct[0],
                               image_size=geo["cli_res"]),
               RetrievalEngine(forward, feats, paths, mesh=mesh,
                               image_size=geo["cli_res"])]
    (v0, i0), (v1, i1) = (e.search_arrays(queries) for e in engines)
    bad = []
    if res["one"]["topk_acc"] != res["mesh"]["topk_acc"] or _rel(
            res["mesh"]["mrr"], res["one"]["mrr"]) > 1e-6:
        bad.append(f"run_inference over {len(devices)} shards: {res}")
    if not np.array_equal(i0, i1):
        bad.append("RetrievalEngine over the cards: other top-k indices")
    return {"shards": [str(d) for d in devices], "run_inference": res,
            "engine_max_abs_distance": float(np.abs(v1 - v0).max()),
            "engine_indices_equal": bool(np.array_equal(i0, i1)),
            "failures": bad}


def card_lines() -> List[str]:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="'cpu' rehearses on 4 CPU ranks at a thin width")
    args = p.parse_args(argv)
    from art_sbir_tpu_torch.parallel import multihost
    from art_sbir_tpu_torch.parallel.mesh import data_mesh

    cpu = args.device == "cpu"
    geo = THIN if cpu else FULL
    devices = (["cpu"] * 4 if cpu
               else [str(d) for d in data_mesh(-1).devices])
    if len(devices) < 2:
        raise SystemExit("probe_dp_cards: needs at least 2 cards")
    world, bad = len(devices), []
    rng = np.random.default_rng(41)
    inputs = make_inputs(rng, geo, b=32, pix_b=8, vae_b=8 if cpu else 64)
    inputs["u8_timing"] = make_inputs(rng, geo, b=32 * world, vae_b=1)["u8"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        one = reference(dict(inputs, u8_timing={
            k: v[:32] for k, v in inputs["u8_timing"].items()}), geo,
            devices[0], tmp / "ref.pt")
        ranks = multihost.spawn(rank_checks, devices, inputs, geo,
                                str(tmp / "ref.pt"))
        bad += failures(ranks)
        print(json.dumps({"part": "steps", "ranks": world,
                          "devices": devices, "backend": ranks["backend"],
                          **{k: ranks[k] for k in ("triplet", "pix2pix",
                                                   "vae")},
                          "s": time.perf_counter() - t0}), flush=True)
        print(json.dumps({"part": "bf16", "one_card_b32": one,
                          f"rank0_of_{world}_b32_a_card": ranks["bf16"]}),
              flush=True)
        from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy

        root = make_synthetic_sketchy(
            tmp / "sketchy", n_classes=25, photos_per_class=18,
            sketches_per_photo=4, size=geo["cli_res"], learnable=True)
        cli = cli_check(tmp, root, devices, geo, dsize=0.1)
        bad += cli["failures"]
        print(json.dumps({"part": "cli", **cli}), flush=True)
        gal = gallery_check(tmp, devices, geo)
        bad += gal["failures"]
        print(json.dumps({"part": "gallery", **gal}), flush=True)
    if not cpu:
        print("\n".join(card_lines()), flush=True)
    if bad:
        print("probe_dp_cards: FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
