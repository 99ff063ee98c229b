"""Gaussian-mixture stroke losses of the Photo2Sketch VAE decoder.

Counterpart of ``art_sbir_tpu/ops/gmm.py`` (reference
`semiSupervised_utils/training_utils.py:5-71`). The reference evaluates
the bivariate normal density (Graves 2013, eq. 24), mixes in probability
space and takes ``-log(sum + 1e-6)``; here the mixture is a logsumexp in
log space and the ``+ 1e-6`` floor is folded in exactly as
``logaddexp(log_mix, log(1e-6))``: the same values, with no underflow and
no NaN far in the tail.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

LOG_EPS = math.log(1e-6)


class GMMParams(NamedTuple):
    """Mixture parameters, each (..., M); ``pen_logits`` (..., 3)."""

    log_pi: torch.Tensor
    mu1: torch.Tensor
    mu2: torch.Tensor
    log_sigma1: torch.Tensor
    log_sigma2: torch.Tensor
    corr: torch.Tensor
    pen_logits: torch.Tensor


def split_decoder_output(y: torch.Tensor, num_mixture: int) -> GMMParams:
    """Raw decoder output (..., 6 M + 3) -> mixture parameters: 3 pen
    logits first, then 6 chunks of M (pi, mu1, mu2, log sigma1, log
    sigma2, rho; reference `models.py:91-100`). pi goes through
    ``log_softmax`` and rho through ``tanh``."""
    pen_logits = y[..., 0:3]
    z_pi, mu1, mu2, ls1, ls2, raw_corr = torch.split(y[..., 3:], num_mixture,
                                                     dim=-1)
    return GMMParams(log_pi=F.log_softmax(z_pi, dim=-1), mu1=mu1, mu2=mu2,
                     log_sigma1=ls1, log_sigma2=ls2,
                     corr=torch.tanh(raw_corr), pen_logits=pen_logits)


def bivariate_normal_logpdf(x1, x2, mu1, mu2, log_s1, log_s2, rho
                            ) -> torch.Tensor:
    """log of Graves eq. 24 (reference `training_utils.py:5-19`)."""
    z1 = (x1 - mu1) * torch.exp(-log_s1)
    z2 = (x2 - mu2) * torch.exp(-log_s2)
    neg_rho = 1.0 - torch.square(rho)
    z = torch.square(z1) + torch.square(z2) - 2.0 * rho * z1 * z2
    log_denom = (math.log(2.0 * math.pi) + log_s1 + log_s2
                 + 0.5 * torch.log(neg_rho))
    return -z / (2.0 * neg_rho) - log_denom


def sketch_reconstruction_loss(params: GMMParams, target_stroke5: torch.Tensor,
                               use_mask: bool = True
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """GMM NLL over (dx, dy) plus the cross-entropy of the 3 pen states.

    ``target_stroke5`` is (..., 5): [dx, dy, p_down, p_up, p_end]. The
    masked form zeroes the steps after the end token by ``1 - p_end``
    (reference `training_utils.py:28,42`); the unmasked one is
    ``sketch_reconstruction_loss_withoutMask`` (`:48-71`). Returns
    (total, stroke NLL, pen CE), each a mean over every (batch, step)."""
    x1 = target_stroke5[..., 0:1]
    x2 = target_stroke5[..., 1:2]
    pen_target = target_stroke5[..., 2:5]

    log_comp = bivariate_normal_logpdf(x1, x2, params.mu1, params.mu2,
                                       params.log_sigma1, params.log_sigma2,
                                       params.corr)
    log_mix = torch.logsumexp(params.log_pi + log_comp, dim=-1)
    # exactly -log(sum_prob + 1e-6), computed stably
    stroke_nll = -torch.logaddexp(log_mix, torch.full_like(log_mix, LOG_EPS))

    pen_label = torch.argmax(pen_target, dim=-1)
    log_probs = F.log_softmax(params.pen_logits, dim=-1)
    pen_ce = -torch.gather(log_probs, -1, pen_label[..., None])[..., 0]

    per_step = stroke_nll + pen_ce
    if use_mask:
        per_step = (1.0 - pen_target[..., 2]) * per_step
    return per_step.mean(), stroke_nll.mean(), pen_ce.mean()


def kl_divergence_to_standard_normal(mean: torch.Tensor,
                                     log_var: torch.Tensor,
                                     kl_tolerance: float = 0.0
                                     ) -> torch.Tensor:
    """KL(N(mean, exp(log_var)) || N(0, 1)), a mean over every element,
    floored at ``kl_tolerance`` (sketch-rnn's; reference
    `semiSupervised_main.py:48-51`)."""
    kl = -0.5 * torch.mean(1.0 + log_var - torch.square(mean)
                           - torch.exp(log_var))
    return torch.clamp(kl, min=kl_tolerance)
