"""pix2pix GAN training: a conditional D and a GAN + lambda * L1 G.

Counterpart of ``art_sbir_tpu/train/gan.py`` (reference
`pix2pix_model.py:279-346`, options at `pix2pix_main.py:147-180`). A step:

* one train-mode forward ``fake = G(A)``; G's running statistics advance
  once, and its dropout masks come from a ``torch.Generator`` seeded with
  the step's ``seed``;
* the D step on ``[A, fake.detach()]`` then ``[A, B]`` (D's running
  statistics chain through both), loss ``(fake + real) / 2``, Adam with
  betas ``(beta1, 0.999)``;
* the G step through the UPDATED D: ``GAN(D([A, fake]), real) + lambda *
  L1(fake, B)``, backward through the same forward of G. D runs in train
  mode there (batch statistics), and its running statistics are put back
  as the D step left them: JAX drops what that pass computes
  (``gan.py:191``);
* ``decoder_only`` (the warm-up epoch) steps D only: G's parameters and
  Adam state stay put, G's running statistics still advance, and the
  three G losses are zeros.

``cfg.bf16`` computes both nets in bf16 while parameters, Adam state and
running statistics stay float32 and the losses are taken in float32 (the
nets return float32). Batches are cast to the parameters' dtype, so nets
cast with ``.double()`` before the first step run the step in float64.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from art_sbir_tpu_torch.core.device import resolve_device
from art_sbir_tpu_torch.models.pix2pix import (GANLoss, define_d, define_g,
                                               init_weights,
                                               set_dropout_generator)
from art_sbir_tpu_torch.train.triplet import torch_adam

LOSS_KEYS = ("G_GAN", "G_L1", "D_real", "D_fake", "G_total", "D_total")


@dataclasses.dataclass(frozen=True)
class Pix2PixConfig:
    """Mirrors the reference option dict (`pix2pix_main.py:147-180`)."""

    input_nc: int = 3
    output_nc: int = 1
    ngf: int = 64
    ndf: int = 64
    net_g: str = "resnet_9blocks"
    net_d: str = "basic"
    n_layers_d: int = 3
    norm: str = "batch"
    gan_mode: str = "vanilla"
    lambda_l1: float = 10.0
    lr: float = 1e-5
    beta1: float = 0.5
    use_dropout: bool = True  # no_dropout=False default
    image_size: int = 256
    bf16: bool = False


class Pix2Pix:
    """G and D with their Adam optimizers. Batches are NCHW: ``A`` (B,
    input_nc, H, W) and ``B`` (B, output_nc, H, W), both in [0, 1]. The
    weights are drawn from a CPU ``torch.Generator`` seeded with ``seed``,
    G's then D's (:func:`~art_sbir_tpu_torch.models.pix2pix.init_weights`).
    """

    def __init__(self, cfg: Pix2PixConfig, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.criterion = GANLoss(cfg.gan_mode)
        compute = torch.bfloat16 if cfg.bf16 else None
        gen = torch.Generator().manual_seed(seed)
        self.net_g = init_weights(define_g(
            cfg.net_g, cfg.output_nc, cfg.ngf, cfg.norm, cfg.use_dropout,
            compute, cfg.input_nc), gen).to(self.device)
        self.net_d = init_weights(define_d(
            cfg.net_d, cfg.ndf, cfg.n_layers_d, cfg.norm, compute,
            cfg.input_nc + cfg.output_nc), gen).to(self.device)
        betas = (cfg.beta1, 0.999)
        self.opt_g = torch_adam(self.net_g.parameters(), cfg.lr, betas=betas)
        self.opt_d = torch_adam(self.net_d.parameters(), cfg.lr, betas=betas)

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, next(self.net_g.parameters()).dtype)

    def _d_pass_keeping_stats(self, x: torch.Tensor) -> torch.Tensor:
        """D in train mode on ``x`` without gradients for D's parameters,
        its running statistics left as they were."""
        saved = [b.clone() for b in self.net_d.buffers()]
        self.net_d.requires_grad_(False)
        try:
            return self.net_d(x)
        finally:
            self.net_d.requires_grad_(True)
            with torch.no_grad():
                for b, s in zip(self.net_d.buffers(), saved):
                    b.copy_(s)

    def train_step(self, batch: Dict[str, torch.Tensor], seed: int,
                   decoder_only: bool = False) -> Dict[str, torch.Tensor]:
        """One G+D step; the losses as 0-d tensors on the device (read
        them when needed: nothing here waits for the card)."""
        cfg, g, d = self.cfg, self.net_g.train(), self.net_d.train()
        real_a, real_b = self._in(batch["A"]), self._in(batch["B"])
        set_dropout_generator(g, torch.Generator(self.device)
                              .manual_seed(int(seed)))
        with torch.set_grad_enabled(not decoder_only):
            fake = g(real_a)

        pred_fake = d(torch.cat([real_a, fake.detach()], 1))
        pred_real = d(torch.cat([real_a, real_b], 1))
        d_fake = self.criterion(pred_fake, False)
        d_real = self.criterion(pred_real, True)
        d_total = (d_fake + d_real) * 0.5
        self.opt_d.zero_grad(set_to_none=True)
        d_total.backward()
        self.opt_d.step()
        losses = {"D_fake": d_fake, "D_real": d_real, "D_total": d_total}

        if decoder_only:
            zero = torch.zeros((), device=self.device)
            losses.update({"G_GAN": zero, "G_L1": zero, "G_total": zero})
        else:
            pred = self._d_pass_keeping_stats(torch.cat([real_a, fake], 1))
            g_gan = self.criterion(pred, True)
            g_l1 = torch.mean(torch.abs(fake - real_b)) * cfg.lambda_l1
            g_total = g_gan + g_l1
            self.opt_g.zero_grad(set_to_none=True)
            g_total.backward()
            self.opt_g.step()
            losses.update({"G_GAN": g_gan, "G_L1": g_l1, "G_total": g_total})
        set_dropout_generator(g, None)
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def eval_losses(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """G's losses in eval mode, no update (reference
        ``calculate_loss``)."""
        real_a, real_b = self._in(batch["A"]), self._in(batch["B"])
        fake = self.net_g.eval()(real_a)
        pred = self.net_d.eval()(torch.cat([real_a, fake], 1))
        g_gan = self.criterion(pred, True)
        g_l1 = torch.mean(torch.abs(fake - real_b)) * self.cfg.lambda_l1
        return {"G_GAN": g_gan, "G_L1": g_l1, "G_total": g_gan + g_l1}

    @torch.no_grad()
    def generate(self, real_a: torch.Tensor) -> torch.Tensor:
        """G in eval mode: (B, output_nc, H, W) tanh outputs, float32
        (float64 in a float64 model)."""
        return self.net_g.eval()(self._in(real_a))

    def state_dict(self) -> Dict[str, Any]:
        return {"g": {"model": self.net_g.state_dict(),
                      "optimizer": self.opt_g.state_dict()},
                "d": {"model": self.net_d.state_dict(),
                      "optimizer": self.opt_d.state_dict()}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for side, net, opt in (("g", self.net_g, self.opt_g),
                               ("d", self.net_d, self.opt_d)):
            net.load_state_dict(state[side]["model"])
            opt.load_state_dict(state[side]["optimizer"])
