"""How far the float32 pix2pix step's gradients lie from float64, on the
card under several cuDNN settings and on the CPU: what sets
``chip_smoke.py``'s ``pix2pix`` rule (each parameter's first Adam
moment on the card within twice the CPU's distance from float64 plus
1e-4).

    python -m art_sbir_tpu_torch.scripts.probe_pix2pix_f32_step [--seeds 0,1,2]

The phase's step: ``Pix2Pix(Pix2PixConfig(use_dropout=False), seed)``
(resnet_9blocks, the basic PatchGAN, batch norm, vanilla; 256 px), one
G+D step on the phase's batch of 2 (``np.random.default_rng(31)``), TF32
off. For each seed: the step in float64 on the card, in float32 on the
CPU, and in float32 on the card as the port runs it (``port``: IEEE
float32 convs and BatchNorm without cuDNN,
``core/device.py::native_ieee_f32``), then with that rule off (cuDNN
for them too): cuDNN's default algorithms, its deterministic ones, both
nets and the batch channels-last, cuDNN off for BatchNorm alone or for
the convolutions alone, and cuDNN off altogether. One JSON line a seed
and card form: the largest ratio of a tensor's distance to the rule's
allowance (above 1 fails), the tensors that come nearest, and the flat
gradient's relative L2 distance from float64 (CPU's beside it). It uses
only ``Pix2Pix``'s public API, so it runs from a checkout of another
commit too (``cd <checkout> && PYTHONPATH=. python <this file>``; there
``port`` and ``default`` are one form where the tree has no such rule).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

from art_sbir_tpu_torch.core.device import ieee_f32
from art_sbir_tpu_torch.train.gan import Pix2Pix, Pix2PixConfig

SIZE, BATCH = 256, 2
FORMS = ("port", "default", "deterministic", "channels_last",
         "bn_native", "conv_native", "no_cudnn")
F = torch.nn.functional


def _native(fn):
    """``fn`` with cuDNN off for the call (the op recorded for the
    backward is the one the forward dispatched to)."""
    def call(*args, **kw):
        with torch.backends.cudnn.flags(enabled=False):
            return fn(*args, **kw)
    return call


def _no_rule(x):
    """In place of the port's ``native_ieee_f32``: cuDNN stays on."""
    return contextlib.nullcontext()


@contextlib.contextmanager
def cudnn(form: str):
    """The card's settings for ``form`` (see the module docstring)."""
    import importlib

    det, on = torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled
    saved = {n: getattr(F, n) for n in ("batch_norm", "conv2d",
                                        "conv_transpose2d")}
    rule = {}
    if form != "port":  # the port's rule off, where the tree has it
        for name in ("resnet", "pix2pix"):
            mod = importlib.import_module(f"art_sbir_tpu_torch.models.{name}")
            if hasattr(mod, "native_ieee_f32"):
                rule[mod] = mod.native_ieee_f32
                mod.native_ieee_f32 = _no_rule
    torch.backends.cudnn.deterministic = form == "deterministic"
    torch.backends.cudnn.enabled = form != "no_cudnn"
    names = {"bn_native": ("batch_norm",),
             "conv_native": ("conv2d", "conv_transpose2d")}.get(form, ())
    for n in names:
        setattr(F, n, _native(saved[n]))
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled = (
            det, on)
        for n, fn in saved.items():
            setattr(F, n, fn)
        for mod, fn in rule.items():
            mod.native_ieee_f32 = fn


def moments(seed: int, batch: dict, device: str, dtype=torch.float32,
            form: str = "default") -> dict:
    """The first Adam moment of every parameter after one step, float64 on
    the CPU."""
    model = Pix2Pix(Pix2PixConfig(use_dropout=False), seed=seed,
                    device=device)
    nets = (("G", model.net_g, model.opt_g), ("D", model.net_d, model.opt_d))
    b = batch
    if dtype == torch.float64:
        model.net_g.double(), model.net_d.double()
    if form == "channels_last":
        for _, net, _ in nets:
            net.to(memory_format=torch.channels_last)
        b = {k: v.contiguous(memory_format=torch.channels_last)
             for k, v in batch.items()}
    with cudnn(form):
        model.train_step(b, 1)
    return {f"{side}.{k}": opt.state[p]["exp_avg"].detach().cpu().double()
            for side, net, opt in nets for k, p in net.named_parameters()}


def flat(m: dict) -> torch.Tensor:
    return torch.cat([m[k].flatten() for k in sorted(m)])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="0,1,2")
    args = p.parse_args(argv)
    ieee_f32()
    rng = np.random.default_rng(31)
    batch = {"A": torch.from_numpy(rng.random((BATCH, 3, SIZE, SIZE),
                                              dtype=np.float32)),
             "B": torch.from_numpy(rng.random((BATCH, 1, SIZE, SIZE),
                                              dtype=np.float32))}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for seed in (int(s) for s in args.seeds.split(",")):
        exact = moments(seed, batch, "cuda", torch.float64)
        scale = max(float(m.abs().max()) for m in exact.values())
        cpu = moments(seed, batch, "cpu")
        rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
        live = [k for k, m in exact.items()
                if float(m.abs().max()) > 1e-6 * scale]
        cpu_err = {k: rel(cpu[k], exact[k]) for k in live}
        for form in FORMS:
            got = moments(seed, batch, "cuda", form=form)
            ratio = sorted(((rel(got[k], exact[k]) / (2 * cpu_err[k] + 1e-4),
                             k) for k in live), reverse=True)
            print(json.dumps({
                "card": card, "seed": seed, "form": form,
                "worst_ratio_to_allowance": ratio[0][0],
                "tensors_past_allowance": sum(r > 1 for r, _ in ratio),
                "nearest": [(k, round(r, 3)) for r, k in ratio[:3]],
                "flat_rel_l2": rel(flat(got), flat(exact)),
                "cpu_flat_rel_l2": rel(flat(cpu), flat(exact))}),
                flush=True)


if __name__ == "__main__":
    main()
