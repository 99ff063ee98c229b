"""Photo2Sketch VAE training: the KL warm-up, the exponential LR decay and
the global-norm gradient clip.

Counterpart of ``art_sbir_tpu/train/vae.py`` (reference
`semiSupervised_main.py:22-135`, hyperparameters at `:187-216`):
Adam(lr 1e-4, betas (0.5, 0.999)) after a clip by global norm 1.0, with
the schedules

    lr(t)   = (lr - min_lr) * decay^t + min_lr                 (decay 0.9999)
    kl_w(t) = kl_weight - (kl_weight - kl_start) * kl_decay^t  (0.99995)

taken at the step count before the update (optax's count, so the first
update uses t = 0), in float32 as JAX computes them. The loss is the
unmasked GMM NLL of the sketch with an explicit ``[0, 0, 0, 0, 1]`` row
appended, plus ``kl_w * max(KL, kl_tolerance)``. The clip is optax's rule:
the gradients are left as they are while their global norm is below
``grad_clip`` and become ``g / norm * grad_clip`` from there on
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` always).

``bf16_encoder`` computes VGG in bf16; the heads, the decoder and the
losses stay float32, and so do the parameters and the Adam state. Batches
are cast to the parameters' dtype, so a model cast with ``.double()``
before the first step runs the step in float64.

Data parallel (each rank of a ``torch.distributed`` group holding its rows
of the batch, ``parallel/mesh.py::shard_or_replicate``): the noise is
drawn for the global ``(B, z_size)`` and each rank keeps its rows
(``rows``), the KL mean is taken over the global batch before the
tolerance clamps it, the gradients are averaged over the ranks before
the clip reads their norm, and the losses are the global batch's. A
ragged batch is replicated: every rank computes it whole.

Tensor parallel (:meth:`VAETrainer.tensor_parallel` in a ``(data,
model)`` grid, ``parallel/tensor.py``): VGG's convs, ``conv_f``,
``conv_h``, ``fc_hc``, ``fc_mu``, ``fc_std`` and the LSTM's gate matrices
keep their ranks' output slices (``conv_att`` and ``fc_params`` are
replicated: 1 and 123 outputs); the noise goes by the data index, and
the clip's global norm sums the sharded gradients' squares over the
model group and adds the replicated ones once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from art_sbir_tpu_torch.core.device import resolve_device
from art_sbir_tpu_torch.models import flax_families
from art_sbir_tpu_torch.models.photo2sketch import Photo2Sketch
from art_sbir_tpu_torch.ops.gmm import (kl_divergence_to_standard_normal,
                                        sketch_reconstruction_loss)
from art_sbir_tpu_torch.parallel.multihost import (global_mean,
                                                   mean_over_ranks,
                                                   reduce_gradients)
from art_sbir_tpu_torch.parallel.tensor import (ModelShard, layout,
                                                tensor_parallel)
from art_sbir_tpu_torch.train.triplet import torch_adam

LOSS_KEYS = ("total_loss", "kl_loss", "reconstruction_loss")
END_ROW = (0.0, 0.0, 0.0, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """The reference's hyperparameters (`semiSupervised_main.py:187-216`)."""

    z_size: int = 128
    dec_rnn_size: int = 512
    num_mixture: int = 20
    max_seq_len: int = 100
    learning_rate: float = 1e-4
    min_learning_rate: float = 1e-5
    decay_rate: float = 0.9999
    kl_weight: float = 1.0
    kl_weight_start: float = 0.01
    kl_decay_rate: float = 0.99995
    kl_tolerance: float = 0.2
    grad_clip: float = 1.0
    use_mask: bool = False  # the reference trains with the unmasked loss
    image_size: int = 256
    bf16_encoder: bool = False


def _f32_decay(base: float, step: int) -> np.float32:
    return np.float32(base) ** np.float32(step)


def lr_at(cfg: VAEConfig, step: int) -> float:
    """The learning rate of the update at step count ``step``."""
    return float(np.float32(cfg.learning_rate - cfg.min_learning_rate)
                 * _f32_decay(cfg.decay_rate, step)
                 + np.float32(cfg.min_learning_rate))


def kl_weight_at(cfg: VAEConfig, step: int) -> float:
    return float(np.float32(cfg.kl_weight)
                 - np.float32(cfg.kl_weight - cfg.kl_weight_start)
                 * _f32_decay(cfg.kl_decay_rate, step))


def clip_by_global_norm(grads, max_norm: float,
                        shard: Optional[ModelShard] = None,
                        sharded: Sequence[bool] = ()) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place on ``grads``; returns the
    global norm before the clip (a 0-d tensor; nothing waits for the
    card). The norm is optax's ``sqrt(sum of sum(g^2))``: torch's
    ``vector_norm`` of a float32 tensor of millions of elements lies up to
    1e-4 from it on the CPU, whose ``sum`` is a cascade. Under tensor
    parallelism (``shard``) the squares of the gradients flagged in
    ``sharded`` (this rank's slices) are summed over the model group and
    the others (replicated, equal on every rank) added once."""
    squares = [torch.sum(torch.square(g)) for g in grads]
    if shard is None or not any(sharded):
        norm = torch.stack(squares).sum().sqrt()
    else:
        local = shard.all_reduce(torch.stack(
            [q for q, f in zip(squares, sharded) if f]).sum())
        norm = torch.stack([local] + [q for q, f in zip(squares, sharded)
                                      if not f]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class VAETrainer:
    """The VAE and its Adam optimizer. Batches hold ``photo`` (B, 3, S, S),
    ImageNet-normalized, and ``sketch_vector`` (B, T, 5). The weights are
    JAX's init under ``jax.random.key(seed)`` (JAX ``train/vae.py:91``,
    the key ``cli/photo2sketch.py`` passes), drawn on the host without
    JAX (:mod:`~art_sbir_tpu_torch.models.flax_families`)."""

    def __init__(self, cfg: VAEConfig, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = Photo2Sketch(
            cfg.z_size, cfg.dec_rnn_size, cfg.num_mixture,
            dtype=torch.bfloat16 if cfg.bf16_encoder else None)
        model.load_state_dict(flax_families.photo2sketch(
            seed, cfg.z_size, cfg.dec_rnn_size, cfg.num_mixture))
        self.model = model.to(self.device)
        self.optimizer = torch_adam(self.model.parameters(),
                                    cfg.learning_rate, betas=(0.5, 0.999))
        self.step = 0
        self.grad_norm: Optional[torch.Tensor] = None

    def tensor_parallel(self, shard: Optional[ModelShard]) -> "VAETrainer":
        """Keep this rank's channel slices of the model (before the first
        step: Adam starts anew on the slices); None: no-op."""
        if shard is not None:
            tensor_parallel(self.model, shard)
            self.optimizer = torch_adam(self.model.parameters(),
                                        self.cfg.learning_rate,
                                        betas=(0.5, 0.999))
        return self

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device,
                                     next(self.model.parameters()).dtype)

    def _noise(self, noise: Union[int, torch.Tensor, torch.Generator],
               b: int = 0, rows: Optional[Tuple[int, int]] = None):
        """A seed becomes a CPU generator's: the noise, drawn on the host
        and moved to the model's device, is then the same on every
        device, as the weights are."""
        if isinstance(noise, int):
            noise = torch.Generator().manual_seed(noise)
        if isinstance(noise, torch.Generator) and rows is not None:
            off, total = rows
            noise = torch.randn(
                (total, self.cfg.z_size), generator=noise,
                device=noise.device,
                dtype=next(self.model.parameters()).dtype)[off:off + b]
        return noise

    def losses(self, batch: Dict, noise,
               rows: Optional[Tuple[int, int]] = None
               ) -> Dict[str, torch.Tensor]:
        """The three losses at the current step count. ``noise`` is the
        reparameterization noise (B, z_size), a ``torch.Generator`` or a
        seed for a CPU one (:meth:`_noise`). ``rows`` = (offset, total):
        ``batch`` is this rank's rows of a global batch of ``total``."""
        cfg = self.cfg
        sketch = self._in(batch["sketch_vector"])
        gmm, mu, log_var = self.model(
            self._in(batch["photo"]), sketch,
            self._noise(noise, sketch.shape[0], rows))
        end = sketch.new_tensor(END_ROW).expand(sketch.shape[0], 1, 5)
        target = torch.cat([sketch, end], dim=1)
        recon, _, _ = sketch_reconstruction_loss(gmm, target, cfg.use_mask)
        kl = torch.clamp(global_mean(kl_divergence_to_standard_normal(
            mu, log_var, float("-inf"))), min=cfg.kl_tolerance)
        total = recon + kl_weight_at(cfg, self.step) * kl
        return {"reconstruction_loss": recon, "kl_loss": kl,
                "total_loss": total}

    def compute_gradients(self, batch: Dict, noise,
                          rows: Optional[Tuple[int, int]] = None
                          ) -> Dict[str, torch.Tensor]:
        """The losses, with this rank's gradients left in the parameters'
        ``.grad`` (not reduced, not clipped)."""
        losses = self.losses(batch, noise, rows)
        self.optimizer.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        return mean_over_ranks({k: v.detach() for k, v in losses.items()})

    def apply_gradients(self) -> None:
        """Average the ``.grad`` of every parameter over the ranks, clip
        them, take the Adam step at ``lr_at(step)`` and count it."""
        reduce_gradients(self.model.parameters())
        params = list(self.model.parameters())
        lay = layout(self.model)
        self.grad_norm = clip_by_global_norm(
            [p.grad for p in params], self.cfg.grad_clip,
            None if lay is None else lay.shard,
            [getattr(p, "tp_dim", None) is not None for p in params])
        for group in self.optimizer.param_groups:
            group["lr"] = lr_at(self.cfg, self.step)
        self.optimizer.step()
        self.step += 1

    def train_step(self, batch: Dict, noise,
                   rows: Optional[Tuple[int, int]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One update; the losses as 0-d tensors on the device."""
        losses = self.compute_gradients(batch, noise, rows)
        self.apply_gradients()
        return losses

    @torch.no_grad()
    def eval_step(self, batch: Dict, noise,
                  rows: Optional[Tuple[int, int]] = None
                  ) -> Dict[str, torch.Tensor]:
        return mean_over_ranks(self.losses(batch, noise, rows))

    @torch.no_grad()
    def generate(self, photos: torch.Tensor, num_steps: int = 101,
                 sample_z: bool = False, generator=None):
        """Greedy decode for the sample sheets (reference
        `semiSupervised_main.py:138-182`): (strokes (B, num_steps, 5),
        attention (B, num_steps, HW))."""
        return self.model.generate(self._in(photos), num_steps, sample_z,
                                   self._noise(generator)
                                   if generator is not None else None)
