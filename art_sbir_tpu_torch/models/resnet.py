"""CLIP-style ModifiedResNet50 retrieval encoder (PyTorch).

Counterpart of ``art_sbir_tpu/models/resnet.py`` (reference
``models.py:191-379``): a 3-conv stem with avgpool, anti-aliased
bottlenecks (the stride is an AvgPool after conv2; the downsample is
avgpool -> 1x1 conv -> BN), and a single-query multi-head attention pool
producing the ``output_dim`` (1024) embedding.

* The public input is NHWC (uint8 or float), as in the JAX package; it is
  cast to the compute dtype and viewed as NCHW, which gives the
  ``channels_last`` layout the convolutions run in.
* ``compute_dtype`` plays flax's ``dtype``: convolutions, projections and
  the attention run in it (bf16 when serving); parameters and BN running
  statistics stay float32. BN in eval mode applies its float32
  scale/shift folded into the compute dtype; in train mode it normalizes
  in float32 and updates its running statistics as flax does (biased
  batch variance).
* State-dict keys keep the reference torch layout (``conv1.weight``,
  ``layer1.0.downsample.0.weight``, ``attnpool.q_proj.weight``, ...), so a
  reference ``.pth`` loads natively.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from art_sbir_tpu_torch.core.device import resolve_device
from art_sbir_tpu_torch.models.layers import BN_MOMENTUM, flax_init
from art_sbir_tpu_torch.parallel.tensor import whole


class Conv2d(nn.Conv2d):
    """Bias-free conv whose float32 weight is cast to the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d (momentum ``BN_MOMENTUM``, eps 1e-5 unless given) with
    float32 state.

    Train mode normalizes by the batch's biased statistics in float32 (or
    the input's dtype where it is wider) and
    updates the running statistics as flax's ``nn.BatchNorm`` does:
    ``running = (1 - m) * running + m * batch`` with the BIASED batch
    variance. torch's own update takes the unbiased variance (n / (n - 1)
    times larger), so it is written out here. ``record`` (a list, or None)
    collects each train-mode call's (mean, biased var) for
    :mod:`art_sbir_tpu_torch.train.bn`.

    ``sync`` (set by ``parallel/multihost.py::synced_batchnorm``) takes
    the statistics of the global batch over the default process group,
    as JAX's BatchNorm under GSPMD does: all-reduce the sums and the
    count, then the centred sums of squares (two passes, as on one
    device). ``torch.distributed.nn``'s all-reduce is differentiable and
    sums the gradients into every rank, as the backward needs; the
    running statistics come out equal on every rank. The reduction runs
    over the data group (``multihost.data_group``).

    Under tensor parallelism (``parallel/tensor.py``) the weight, bias and
    running statistics hold this rank's channels (``tp``, ``tp_dims``):
    the input is whole, so the forward gathers them (one collective a
    call) and a running-statistics update writes the rank's slice."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__(c, eps=eps, momentum=BN_MOMENTUM)
        self.record = None
        self.sync = False

    def _global_norm(self, xf: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor):
        """(output, mean, biased var) over every rank's rows."""
        from torch.distributed.nn.functional import all_reduce

        from art_sbir_tpu_torch.parallel.multihost import data_group

        group = data_group()
        n = xf.shape[0] * xf.shape[2] * xf.shape[3]
        s = all_reduce(torch.cat([xf.sum(dim=(0, 2, 3)),
                                  xf.new_full((1,), float(n))]), group=group)
        mean = s[:-1] / s[-1]
        centred = xf - mean[None, :, None, None]
        var = all_reduce(torch.square(centred).sum(dim=(0, 2, 3)),
                         group=group) / s[-1]
        scale = weight * torch.rsqrt(var + self.eps)
        out = (centred * scale[None, :, None, None]
               + bias[None, :, None, None])
        return out, mean.detach(), var.detach()

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's channels of a whole (C,) vector."""
        tp = getattr(self, "tp", None)
        return t if tp is None else tp.local(t, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            weight, bias = whole(self, "weight", "bias")
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            if self.sync:
                out, mean, var = self._global_norm(xf, weight, bias)
            else:
                out = F.batch_norm(xf, None, None, weight, bias,
                                   True, 0.0, self.eps)
                with torch.no_grad():
                    var, mean = torch.var_mean(xf, dim=(0, 2, 3),
                                               correction=0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(self._local(mean),
                                                     alpha=m)
                self.running_var.mul_(1.0 - m).add_(self._local(var),
                                                    alpha=m)
                self.num_batches_tracked.add_(1)
                if self.record is not None:
                    self.record.append((mean, var))
            return out.to(x.dtype)
        weight, bias, running_mean, running_var = whole(
            self, "weight", "bias", "running_mean", "running_var")
        scale = weight * torch.rsqrt(running_var + self.eps)
        shift = bias - running_mean * scale
        return torch.addcmul(shift.to(x.dtype)[None, :, None, None], x,
                             scale.to(x.dtype)[None, :, None, None])


class Bottleneck(nn.Module):
    """All convs stride 1; spatial reduction by AvgPool2d(stride) after
    conv2 (reference ``models.py:191-236``)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = Conv2d(planes, out, 1)
        self.bn3 = BatchNorm2d(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity()),
                ("0", Conv2d(inplanes, out, 1)),
                ("1", BatchNorm2d(out)),
            ]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self.avgpool(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """Single-query (mean-token) multi-head QKV pooling with a learned
    positional embedding (reference ``models.py:239-272``). The embedding
    is added in the token dtype; the softmax runs in float32. Under
    tensor parallelism the embedding holds this rank's columns and the
    forward gathers it."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(spacial_dim ** 2 + 1, embed_dim) / embed_dim ** 0.5)
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim)
        self.num_heads = num_heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # (B, HW, C)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        (pe,) = whole(self, "positional_embedding")
        tokens = tokens + pe[None].to(tokens.dtype)
        h = self.num_heads
        hd = c // h
        # only the mean token is ever a query (the reference queries x[:1])
        q = self.q_proj(tokens[:, :1]).reshape(b, 1, h, hd) * hd ** -0.5
        k = self.k_proj(tokens).reshape(b, -1, h, hd)
        v = self.v_proj(tokens).reshape(b, -1, h, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k)
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        pooled = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, c)
        return self.c_proj(pooled)


class ModifiedResNet(nn.Module):
    """The CLIP RN50 visual tower (reference ``models.py:275-360``).
    ``forward``: NHWC (B, S, S, 3) -> float32 (B, output_dim) (float64 in
    a float64 model)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 output_dim: int = 1024, heads: int = 32,
                 input_resolution: int = 224, width: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.layers = tuple(layers)
        self.conv1 = Conv2d(3, width // 2, 3, stride=2)
        self.bn1 = BatchNorm2d(width // 2)
        self.conv2 = Conv2d(width // 2, width // 2, 3)
        self.bn2 = BatchNorm2d(width // 2)
        self.conv3 = Conv2d(width // 2, width, 3)
        self.bn3 = BatchNorm2d(width)
        self.avgpool = nn.AvgPool2d(2)
        inplanes = width
        for stage, blocks in enumerate(self.layers, start=1):
            planes = width * 2 ** (stage - 1)
            mods = []
            for i in range(blocks):
                mods.append(Bottleneck(inplanes, planes,
                                       2 if (i == 0 and stage > 1) else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*mods))
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32,
                                        heads, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # channels_last
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = self.avgpool(x)
        for stage in range(1, len(self.layers) + 1):
            x = getattr(self, f"layer{stage}")(x)
        out = self.attnpool(x)
        return out.to(torch.promote_types(out.dtype, torch.float32))


class ModifiedResNetWithClassification(ModifiedResNet):
    """Adds 1-2 float32 linear classifier heads on the embedding (reference
    ``models.py:363-379``). Returns (feature, logits[, logits2])."""

    def __init__(self, num_classes: int = 125, num_classes2: int = 0, **kw):
        super().__init__(**kw)
        out = self.attnpool.c_proj.out_features
        self.classifier = nn.Linear(out, num_classes)
        self.classifier2 = (nn.Linear(out, num_classes2) if num_classes2
                            else None)

    def forward(self, x: torch.Tensor):
        feature = super().forward(x)
        logits = self.classifier(feature)
        if self.classifier2 is None:
            return feature, logits
        return feature, logits, self.classifier2(feature)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded fresh init from an explicit CPU ``torch.Generator`` (the same
    weights on every device), in the JAX package's distributions
    (:func:`~art_sbir_tpu_torch.models.layers.flax_init`): conv and linear
    weights, the classifier heads included, flax's ``lecun_normal`` (a
    normal truncated at +-2 of its stds, variance 1/fan_in), zero biases,
    identity BatchNorm, and the positional embedding N(0, 1)/sqrt(C)
    (JAX ``resnet.py:96-100``)."""
    gen = torch.Generator().manual_seed(seed)
    flax_init(model, gen=gen)
    for mod in model.modules():
        if isinstance(mod, AttentionPool2d):
            pe = mod.positional_embedding
            pe.copy_(torch.randn(pe.shape, generator=gen) / pe.shape[1] ** 0.5)
    return model


def create_encoder(with_classification: bool = False, num_classes: int = 125,
                   num_classes2: int = 0,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device | None = None, seed: int = 0,
                   **kw) -> nn.Module:
    """Factory mirroring the reference model choices (``utils.py:132-206``):
    a seeded fresh init on ``device`` (the card unless ``device='cpu'``),
    in eval mode. ``kw``: layers, output_dim, heads, input_resolution,
    width."""
    dev = resolve_device(device)
    if with_classification:
        model = ModifiedResNetWithClassification(
            num_classes=num_classes, num_classes2=num_classes2,
            compute_dtype=compute_dtype, **kw)
    else:
        model = ModifiedResNet(compute_dtype=compute_dtype, **kw)
    return init_weights(model, seed).to(dev).eval()
