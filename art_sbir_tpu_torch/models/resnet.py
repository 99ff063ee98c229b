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
  statistics stay float32. BN normalizes in float32 (or the input's
  dtype where it is wider) and casts its output to the compute dtype
  once, as flax's ``nn.BatchNorm(dtype=bfloat16)`` does: in eval mode a
  bf16 input goes through ``F.batch_norm`` with the float32 statistics
  (one kernel that computes in float32), a float32 one through the
  float32 scale/shift fold; in train mode it updates its running
  statistics as flax does (biased batch variance). In eval mode
  :func:`conv_bn` hands BN the bf16 convolution's float32 accumulator,
  as XLA's fusion of the two does.
* State-dict keys keep the reference torch layout (``conv1.weight``,
  ``layer1.0.downsample.0.weight``, ``attnpool.q_proj.weight``, ...), so a
  reference ``.pth`` loads natively.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from art_sbir_tpu_torch.core.device import native_ieee_f32, resolve_device
from art_sbir_tpu_torch.models.flax_draw import encoder_state
from art_sbir_tpu_torch.models.layers import BN_MOMENTUM
from art_sbir_tpu_torch.parallel.tensor import whole


class Conv2d(nn.Conv2d):
    """A conv whose float32 weight and bias are cast to the input's dtype
    (``padding`` defaults to ``kernel // 2``, and there is no bias unless
    asked for).

    ``to_bn``: the conv feeds a BatchNorm (:func:`conv_bn`). Then in eval
    mode a bf16 input gives the float32 accumulator: the operands keep
    their bf16 values, the products and the sums run in float32 and
    nothing is rounded after them. cuDNN runs that conv in TF32, which
    holds every bf16 operand exactly, whatever the process set for its
    float32 work (``core/device.py::ieee_f32``). Otherwise, in train mode
    and for a float32 input, the output is in the input's dtype; an IEEE
    float32 conv on the card runs without cuDNN
    (``core/device.py::native_ieee_f32``)."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=None, bias: bool = False):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2 if padding is None else padding,
                         bias=bias)

    def forward(self, x: torch.Tensor, to_bn: bool = False) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        acc = torch.promote_types(x.dtype, torch.float32)
        if not to_bn or self.training or acc == x.dtype:
            with native_ieee_f32(x):
                return self._conv_forward(x, w, b)
        with float32_accumulator():
            return self._conv_forward(x.to(acc), w.to(acc),
                                      None if b is None else b.to(acc))


@contextlib.contextmanager
def float32_accumulator():
    """cuDNN's TF32 on for the convs inside: exact for bf16 operands (a
    float32 conv of bf16 values is the bf16 conv's accumulator)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d (momentum ``BN_MOMENTUM``, eps 1e-5 unless given) with
    float32 state.

    Train mode normalizes by the batch's biased statistics in float32 (or
    the input's dtype where it is wider; an IEEE float32 input on the
    card without cuDNN, ``core/device.py::native_ieee_f32``) and
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
                with native_ieee_f32(x):  # a bf16 model's keeps cuDNN
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
        if x.dtype != torch.promote_types(x.dtype, torch.float32):
            # flax's dtype=bfloat16: normalize in float32, cast once
            return F.batch_norm(x, running_mean, running_var, weight, bias,
                                False, 0.0, self.eps)
        # the fold in x's dtype (float32, or wider; bf16 parameters, as a
        # model cast whole to bf16 holds, are widened to it)
        weight, bias, running_mean, running_var = (
            t.to(x.dtype) for t in (weight, bias, running_mean, running_var))
        scale = weight * torch.rsqrt(running_var + self.eps)
        shift = bias - running_mean * scale
        return torch.addcmul(shift[None, :, None, None], x,
                             scale[None, :, None, None])


def conv_bn(conv: nn.Module, bn: BatchNorm2d, x: torch.Tensor
            ) -> torch.Tensor:
    """``bn(conv(x))`` in ``x``'s dtype, as XLA compiles flax's pair. In
    eval mode BN, a per-channel affine map there, is fused into the
    convolution and normalizes its float32 accumulator, so a bf16 pair
    rounds once: rounding the conv's output first would lose the low bits
    that BN's subtraction of the running mean keeps. In train mode the
    conv's output is rounded before the batch statistics, as there.
    ``conv``: a :class:`Conv2d`, or pix2pix's transposed conv (XLA fuses
    that pair the same way)."""
    return bn(conv(x, to_bn=True)).to(x.dtype)


class Sequential(nn.Sequential):
    """``nn.Sequential`` that runs each conv directly followed by a
    :class:`BatchNorm2d` through :func:`conv_bn`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mods = list(self)
        i = 0
        while i < len(mods):
            if (i + 1 < len(mods) and isinstance(mods[i + 1], BatchNorm2d)
                    and isinstance(mods[i], (nn.Conv2d, nn.ConvTranspose2d))):
                x = conv_bn(mods[i], mods[i + 1], x)
                i += 2
            else:
                x = mods[i](x)
                i += 1
        return x


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
        out = F.relu(conv_bn(self.conv1, self.bn1, x))
        out = F.relu(conv_bn(self.conv2, self.bn2, out))
        out = conv_bn(self.conv3, self.bn3, self.avgpool(out))
        identity = x
        if self.downsample is not None:
            pool, conv, bn = self.downsample
            identity = conv_bn(conv, bn, pool(x))
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
        x = F.relu(conv_bn(self.conv1, self.bn1, x))
        x = F.relu(conv_bn(self.conv2, self.bn2, x))
        x = F.relu(conv_bn(self.conv3, self.bn3, x))
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
    """The JAX package's fresh init for ``seed``: the weights of
    ``model.init(jax.random.key(seed), ...)`` (JAX ``train/triplet.py``'s
    ``create_train_state``), drawn on the host without JAX by
    :func:`~art_sbir_tpu_torch.models.flax_draw.encoder_state` (flax's
    key paths and ``lecun_normal`` kernels, zero biases, identity
    BatchNorm, the positional embedding N(0, 1)/sqrt(C), JAX
    ``resnet.py:96-100``), so ``--seed s`` gives JAX's ``--seed s`` init
    on every device. The configuration is read off ``model``."""
    heads = ()
    if isinstance(model, ModifiedResNetWithClassification):
        heads = (("classifier", model.classifier.out_features),)
        if model.classifier2 is not None:
            heads += (("classifier2", model.classifier2.out_features),)
    pool = model.attnpool
    state = encoder_state(seed, model.layers, model.conv3.out_channels,
                          pool.positional_embedding.shape[0],
                          pool.c_proj.out_features, heads)
    model.load_state_dict(state)
    return model


def create_encoder(with_classification: bool = False, num_classes: int = 125,
                   num_classes2: int = 0,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device | None = None, seed: int = 0,
                   **kw) -> nn.Module:
    """Factory mirroring the reference model choices (``utils.py:132-206``):
    JAX's fresh init for ``seed`` (:func:`init_weights`) on ``device``
    (the card unless ``device='cpu'``), in eval mode. ``kw``: layers,
    output_dim, heads, input_resolution, width."""
    dev = resolve_device(device)
    if with_classification:
        model = ModifiedResNetWithClassification(
            num_classes=num_classes, num_classes2=num_classes2,
            compute_dtype=compute_dtype, **kw)
    else:
        model = ModifiedResNet(compute_dtype=compute_dtype, **kw)
    return init_weights(model, seed).to(dev).eval()
