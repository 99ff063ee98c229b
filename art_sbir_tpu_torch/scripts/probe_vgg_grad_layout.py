"""How far the card's float32 VAE gradients lie from float64, and how long
a step takes, with VGG's activations and weights channels-last (as
``models/vgg.py`` keeps them), NCHW, or NCHW without cuDNN.

    python -m art_sbir_tpu_torch.scripts.probe_vgg_grad_layout
        [--batch B] [--time_batch T]

One full-width Photo2Sketch step (``train/vae.py``, TF32 off, seed-0
weights with VGG's convs He-initialized as ``chip_smoke.py`` does, a fed
eps) at 256 px, batch ``B``: the gradients of VGG's 13 conv weights in
float64 on the card, then in float32 in each layout on the card and
(channels-last and NCHW) on the CPU; each float32 gradient's norm-wise
distance from float64; the card's FFT kernels of the NCHW backward. Then
the median train step at batch ``T`` on the card (CUDA events, 5 after
2) in each layout, float32 and bf16 (bf16 not without cuDNN). Prints one
JSON line with the card's name and power limit. Runs on the card only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

import numpy as np
import torch
from torch import nn

from art_sbir_tpu_torch.core.device import ieee_f32
from art_sbir_tpu_torch.models.vgg import CONV_INDICES
from art_sbir_tpu_torch.train.vae import VAEConfig, VAETrainer

LAYOUTS = ("channels_last", "nchw", "nchw_no_cudnn")


def _trainer(device: str, layout: str = "channels_last",
             dtype: torch.dtype = torch.float32,
             bf16: bool = False) -> VAETrainer:
    trainer = VAETrainer(VAEConfig(bf16_encoder=bf16), seed=0, device=device)
    vgg = trainer.model.Image_Encoder.feature
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for mod in vgg.modules():
            if isinstance(mod, nn.Conv2d):
                w = mod.weight
                w.copy_(torch.randn(w.shape, generator=gen)
                        * (2.0 / w[0].numel()) ** 0.5)
                mod.bias.zero_()
    if layout != "channels_last":
        vgg.to(memory_format=torch.contiguous_format)
        vgg.forward = _nchw_forward(vgg)
    trainer.model.to(dtype)
    return trainer


def _nchw_forward(vgg):
    """``VGGFeatures.forward`` on NCHW-contiguous activations."""
    def forward(x):
        x = x.contiguous()
        if vgg.dtype is None:
            return nn.Sequential.forward(vgg, x)
        x = x.to(vgg.dtype)
        for layer in vgg:
            if isinstance(layer, nn.Conv2d):
                x = nn.functional.conv2d(x, layer.weight.to(vgg.dtype),
                                         layer.bias.to(vgg.dtype), padding=1)
            else:
                x = layer(x)
        return x
    return forward


def _backend(layout: str):
    if layout == "nchw_no_cudnn":
        return torch.backends.cudnn.flags(enabled=False)
    return contextlib.nullcontext()


def _weight_grads(trainer: VAETrainer, batch, eps, layout: str) -> dict:
    with _backend(layout):
        trainer.compute_gradients(batch, eps)
    vgg = trainer.model.Image_Encoder.feature
    return {i: vgg[i].weight.grad.detach().cpu().double()
            for i in CONV_INDICES}


def _batch(rng, b: int):
    sketch = np.zeros((b, 100, 5), np.float32)
    sketch[:, :, :2] = rng.standard_normal((b, 100, 2))
    sketch[:, :, 2] = 1.0
    sketch[:, 60:, 2:] = [0, 0, 1]
    batch = {"photo": torch.from_numpy(rng.standard_normal(
                 (b, 3, 256, 256)).astype(np.float32)),
             "sketch_vector": torch.from_numpy(sketch)}
    eps = torch.from_numpy(rng.standard_normal((b, 128)).astype(np.float32))
    return batch, eps


def _step_ms(trainer: VAETrainer, batch, eps, layout: str) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    with _backend(layout):
        for _ in range(7):  # 2 warm-up steps, then 5 timed
            start.record()
            trainer.train_step(batch, eps)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return float(np.median(times[2:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--time_batch", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_vgg_grad_layout: needs the card", file=sys.stderr)
        return 1
    ieee_f32()
    rng = np.random.default_rng(37)
    batch, eps = _batch(rng, args.batch)
    exact = _weight_grads(_trainer("cuda", dtype=torch.float64), batch, eps,
                          "channels_last")
    out = {"batch": args.batch, "grad_rel_err_vs_f64": {}}
    runs = [("card", layout) for layout in LAYOUTS] + [
        ("cpu", "channels_last"), ("cpu", "nchw")]
    for dev, layout in runs:
        got = _weight_grads(_trainer("cuda" if dev == "card" else "cpu",
                                     layout), batch, eps, layout)
        out["grad_rel_err_vs_f64"][f"{dev}_{layout}"] = {
            str(i): float((got[i] - exact[i]).norm() / exact[i].norm())
            for i in CONV_INDICES}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer = _trainer("cuda", "nchw")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.compute_gradients(batch, eps)
        torch.cuda.synchronize()
    out["card_nchw_fft_kernels_ms"] = {
        ev.key[:90]: ev.self_device_time_total / 1e3
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and (
            "fft" in ev.key.lower() or "cf32" in ev.key)}
    del trainer
    big, big_eps = _batch(rng, args.time_batch)
    big = {k: v.cuda() for k, v in big.items()}
    big_eps = big_eps.cuda()
    out["time_batch"] = args.time_batch
    out["step_ms_median"] = {}
    for bf16 in (False, True):
        for layout in LAYOUTS:
            if bf16 and layout == "nchw_no_cudnn":
                continue
            trainer = _trainer("cuda", layout, bf16=bf16)
            out["step_ms_median"][f"{'bf16' if bf16 else 'f32'}_{layout}"] = \
                _step_ms(trainer, big, big_eps, layout)
            del trainer
            torch.cuda.empty_cache()
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
