"""CLIP transformer pieces: fp16-safe LayerNorm, QuickGELU and the
ResidualAttentionBlock (reference `models.py:382-417`; the reference
defines them but wires no ViT path).

Counterpart of ``art_sbir_tpu/models/transformer.py``. The block takes
(B, T, D) batch-first, as the JAX package's does (the reference's
``nn.MultiheadAttention`` is sequence-first), and keeps the reference's
state-dict keys: ``ln_1``, ``attn.in_proj_weight`` (q, k and v stacked,
(3D, D)), ``attn.in_proj_bias``, ``attn.out_proj``, ``ln_2``,
``mlp.c_fc``, ``mlp.c_proj``. The projections are plain
``torch.matmul``s, heads split as flax's ``MultiHeadDotProductAttention``
splits them; each runs in the promoted type of its input and its float32
weight, as flax's ``Dense`` does, so a float16 input gives a float32
attention branch and a float32 sum (JAX's block returns float32 there
too; ``LayerNormFp32`` itself returns the input's dtype).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn



def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) (reference `models.py:391-393`)."""
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quick_gelu(x)


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm computed in float32 whatever the activation dtype, cast
    back to it (reference `models.py:382-388`)."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__(d, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.float(), self.normalized_shape,
                           self.weight.float(), self.bias.float(), self.eps)
        return out.to(x.dtype)


def _linear(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """``x @ weight^T + bias`` in the promoted type of ``x`` and ``weight``."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    return torch.matmul(x.to(dt), weight.to(dt).t()) + bias.to(dt)


class MultiheadAttention(nn.Module):
    """Self-attention holding ``nn.MultiheadAttention``'s parameters
    (``in_proj_weight``, ``in_proj_bias``, ``out_proj``), computed with
    matmuls: q scaled by 1/sqrt(D/H), masked logits set to the dtype's
    minimum, softmax, the heads merged and projected."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        h = self.n_head
        q, k, v = _linear(x, self.in_proj_weight,
                          self.in_proj_bias).split(d, dim=-1)
        q = q.reshape(b, t, h, d // h) / (d // h) ** 0.5
        k = k.reshape(b, t, h, d // h)
        v = v.reshape(b, t, h, d // h)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if keep is not None:
            logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, d)
        return _linear(out, self.out_proj.weight, self.out_proj.bias)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block with a QuickGELU MLP (reference
    `models.py:396-417`). Input (B, T, D); ``attn_mask`` an optional
    additive float (T, T) mask, taken as JAX's block takes it: a position
    is kept where ``attn_mask > -1.0`` (JAX ``transformer.py:49-51``)."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.ln_1 = LayerNormFp32(d_model)
        self.attn = MultiheadAttention(d_model, n_head)
        self.ln_2 = LayerNormFp32(d_model)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(d_model, d_model * 4)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(d_model * 4, d_model)),
        ]))

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        keep = None if attn_mask is None else (attn_mask > -1.0)[None, None]
        x = x + self.attn(self.ln_1(x), keep)
        return x + self.mlp(self.ln_2(x))


def init_weights(block: ResidualAttentionBlock, seed: int = 0
                 ) -> ResidualAttentionBlock:
    """JAX's init of the block under ``jax.random.key(seed)`` (flax's
    ``MultiHeadDotProductAttention`` and ``Dense`` defaults: truncated
    ``lecun_normal`` kernels, zero biases; LayerNorm scale 1, bias 0),
    drawn on the host without JAX
    (:mod:`~art_sbir_tpu_torch.models.flax_families`)."""
    from art_sbir_tpu_torch.models import flax_families

    block.load_state_dict(flax_families.residual_attention_block(
        seed, block.ln_1.normalized_shape[0]))
    return block


def causal_mask(t: int, device=None) -> torch.Tensor:
    """A causal additive mask, as CLIP's text tower builds it: 0 on and
    below the diagonal, -inf above."""
    return torch.full((t, t), float("-inf"), device=device).triu_(1)
