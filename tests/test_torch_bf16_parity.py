"""The port's bf16 arithmetic against flax's ``dtype=bfloat16``.

JAX is run with XLA's ``xla_allow_excess_precision`` off: then every op
rounds to its dtype as flax's modules say, and the result equals JAX's
op-by-op (eager) apply bit for bit. XLA's default lets a fusion skip the
bf16 roundings between the ops it fuses, so a jitted JAX forward keeps
more precision than its modules state. Its largest skip, the rounding of
a conv's output before the BN that follows, the port's eval mode skips
too (``models/resnet.py::conv_bn``): on the thin encoder below the port
then lies as near float64 as jitted JAX (0.99x on the mean of the six
cases, 1.06x at most; 1.21x and 1.35x with the conv's output rounded,
as the port did before). The pix2pix nets hand BN the float32
accumulator of their convs and transposed convs too (jitted XLA fuses
both pairs: a transposed conv and its BN lie within half a bf16 ulp of
the float32 accumulator's normalization, and hundreds of ulps from the
rounded one's), as do InceptionV3's ``BasicConv2d`` and
``GlobalGenerator2``; train mode still rounds the conv's output
(ROADMAP.md §3).

Audit, op by op (the port's ``compute_dtype=bfloat16`` against flax's
``dtype=bfloat16``; parameters and BN statistics float32 in both):

=====================  =================================  =================================
op                     flax                               port
=====================  =================================  =================================
input                  ``x.astype(bf16)``                 ``x.to(bf16)``: same
conv                   input and kernel in bf16, bf16     the same (float32 accumulation
                       out (float32 accumulation)         in oneDNN and cuDNN); before
                                                          BN in eval mode, float32 out
                                                          (``conv_bn``, as XLA fuses
                                                          them): nearer exact
BN, train              batch statistics in float32,       float32, two passes (logged in
                       one pass E[x^2] - E[x]^2           §3: the port's is nearer exact)
BN, eval               ``(x - mean) * (rsqrt(var + eps)   was: scale and shift folded into
                       * scale) + bias`` in float32,      bf16, ``addcmul`` in bf16 (the
                       cast once                          fault); now ``F.batch_norm`` in
                                                          float32, cast once
ReLU, residual add     bf16                               bf16: same
avg_pool               bf16 sum, then the division:       one rounding (float32 inside):
                       two roundings                      nearer exact
attnpool mean token    float32 sum, bf16 out              the same
positional add         embedding cast to bf16, bf16 add   the same
q/k/v/c_proj           bf16 product, then the bias in     one rounding (the bias inside
                       bf16: two roundings                the product): nearer exact
q scale, q.k, attn.v   bf16                               bf16: same
softmax                float32, cast to bf16              the same
heads, loss            float32 on the float32 feature     the same
=====================  =================================  =================================

The tests: (a) one eval-mode BN layer with statistics far from 0 and 1
equals flax's to one bf16 ulp of the output, and a conv with its BN
jitted flax's (XLA's fusion) to one ulp; (b) the thin encoder, (c) the
thin pix2pix generator and (e) InceptionV3 at its smallest input (75
px) in eval mode, from JAX's fresh init for the seed, their BN
statistics set to the batch's own (one float32 train-mode pass at
momentum 1, as a trained net normalizes), 3 seeds x 2 input offsets:
the port's relative L2 distance to its float64 forward is at most 1.25x
JAX's bf16 distance in each case and 1.10x on the mean (the old fold:
1.46x at most, 1.26x on the mean of the encoder's). The encoder is held
to JAX with every op rounding (below); the generator and InceptionV3 to
jitted JAX, XLA's default (the generator with its conv's output rounded
before BN, as the port did before: 1.21x on the mean, 1.30x at most).
flax's ``InceptionV3`` has no compute dtype: its bf16 form, on both
sides, is the whole model cast to bf16 (parameters, statistics, input),
where flax's BN computes in bf16 and jitted XLA keeps that rounding.
(d) one bf16 train step (three train-mode forwards, the triplet loss,
the backward): the port's loss and gradient lie no farther from float64
than 1.25x JAX's bf16 step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from art_sbir_tpu.models import inception as JI
from art_sbir_tpu.models import pix2pix as JP
from art_sbir_tpu.models import torch_port as TP
from art_sbir_tpu.models.layers import ConvTranspose as FlaxConvTranspose
from art_sbir_tpu.models.resnet import ModifiedResNet as FlaxResNet
from art_sbir_tpu.train import losses as JL
from art_sbir_tpu.train import triplet as JT
from art_sbir_tpu_torch.models import flax_families as FF
from art_sbir_tpu_torch.models import inception as PI
from art_sbir_tpu_torch.models import pix2pix as PP
from art_sbir_tpu_torch.models import port_weights as PW
from art_sbir_tpu_torch.models import resnet as R
from art_sbir_tpu_torch.models.layers import BN_MOMENTUM
from art_sbir_tpu_torch.train import losses as PL
from art_sbir_tpu_torch.train import triplet as PT
from tests.torch_threads import two_torch_threads  # noqa: F401

LAYERS = (2, 1, 1, 1)
GEOM = dict(layers=LAYERS, output_dim=32, heads=4, input_resolution=64,
            width=8)
NGF, BLOCKS = 8, 2
CASES = [(seed, offset) for seed in (0, 1, 2) for offset in (0.0, 3.0)]
CASE_BOUND, MEAN_BOUND = 1.25, 1.10


_COMPILED = {}


def strict(name: str, fn, *args, excess_precision: bool = False):
    """``fn(*args)``, compiled once per ``name`` (every call of a name has
    the same shapes) with every op rounding to its dtype, or with XLA's
    default (``excess_precision``: a fusion may skip the bf16 roundings
    inside it, as ``jax.jit`` compiles)."""
    if name not in _COMPILED:
        _COMPILED[name] = jax.jit(fn).lower(*args).compile(
            compiler_options={
                "xla_allow_excess_precision": excess_precision})
    return _COMPILED[name](*args)


def jitted(name: str, fn, *args):
    """``fn(*args)`` as ``jax.jit`` compiles it, once per ``name``."""
    return strict(name, fn, *args, excess_precision=True)


def rel(got, want) -> float:
    got, want = np.ravel(got), np.ravel(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def calibrate(model: torch.nn.Module, x: torch.Tensor) -> dict:
    """The state of ``model`` (float32) after one train-mode pass over
    ``x`` at momentum 1: every BN's running statistics are the batch's."""
    bns = [m for m in model.modules() if isinstance(m, R.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x)
    for m in bns:
        m.momentum = BN_MOMENTUM
    return model.state_dict()


def numpy_sd(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def flat(out) -> np.ndarray:
    """A forward's output (an array, or a tuple of them) as one float64
    vector."""
    outs = out if isinstance(out, tuple) else (out,)
    return np.concatenate([torch.as_tensor(o).double().numpy().ravel()
                           for o in outs])


def forward(model: torch.nn.Module, sd: dict, x: torch.Tensor) -> np.ndarray:
    model.load_state_dict(sd)
    with torch.no_grad():
        return flat(model.eval()(x))


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at ``|v|`` (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


# ------------------------------------------------------- (a) one BN layer


def test_eval_batchnorm_bf16_is_flax():
    """Running means up to 50 sigma from 0: flax normalizes the bf16 input
    in float32 and casts once; so does the port (the fold into bf16 missed
    by up to 0.16 here)."""
    rng = np.random.default_rng(0)
    c = 16
    sigma = rng.uniform(0.5, 4.0, c).astype(np.float32)
    mean = (sigma * rng.uniform(-50, 50, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.5 * rng.standard_normal(c)).astype(np.float32)
    x = jnp.asarray(mean + sigma * rng.standard_normal((4, 8, 8, c)),
                    jnp.bfloat16)
    bn = nn.BatchNorm(use_running_average=True, epsilon=1e-5,
                      dtype=jnp.bfloat16)
    want = np.asarray(bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": sigma ** 2}},
        x).astype(jnp.float32))
    port = R.BatchNorm2d(c).eval()
    port.load_state_dict({
        "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
        "running_mean": torch.from_numpy(mean),
        "running_var": torch.from_numpy(sigma ** 2),
        "num_batches_tracked": torch.tensor(0)})
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert np.all(np.abs(got - want) <= bf16_ulp(want))


def conv_bn_case(transposed: bool) -> tuple:
    """(port's ``conv_bn``, the port with the conv's output rounded first,
    jitted flax) of a bf16 conv, or transposed conv (pix2pix's up path),
    and its BN in eval mode, running means up to 30 sigma from 0."""
    rng = np.random.default_rng(0)
    cin, c = 8, 16
    x = (1.0 + rng.standard_normal((4, 8, 8, cin))).astype(np.float32)
    if transposed:
        conv = PP.ConvTranspose2d(cin, c, 3, stride=2, padding=1,
                                  output_padding=1, bias=False).eval()
    else:
        conv = R.Conv2d(cin, c, 3).eval()
    w = (rng.standard_normal(conv.weight.shape) / np.sqrt(cin * 9)).astype(
        np.float32)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        y = conv(xt, to_bn=True)
    # the running statistics: the batch's mean, a sigma 5-20x narrower
    mean = y.mean(dim=(0, 2, 3)).numpy()
    sigma = (y.std(dim=(0, 2, 3)).numpy()
             * rng.uniform(0.05, 0.2, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.5 * rng.standard_normal(c)).astype(np.float32)

    class ConvBN(nn.Module):
        @nn.compact
        def __call__(self, x):
            if transposed:
                y = FlaxConvTranspose(c, 3, stride=2, padding=1,
                                      output_padding=1, use_bias=False,
                                      dtype=jnp.bfloat16, name="Conv_0")(x)
            else:
                y = nn.Conv(c, (3, 3), padding=1, use_bias=False,
                            dtype=jnp.bfloat16)(x)
            return nn.BatchNorm(use_running_average=True, epsilon=1e-5,
                                dtype=jnp.bfloat16)(y)

    # both kernels go (2, 3, 1, 0): HWIO, and the transposed (k, k, out, in)
    v = {"params": {"Conv_0": {"kernel": w.transpose(2, 3, 1, 0)},
                    "BatchNorm_0": {"scale": scale, "bias": bias}},
         "batch_stats": {"BatchNorm_0": {"mean": mean, "var": sigma ** 2}}}
    want = np.asarray(jax.jit(ConvBN().apply)(v, x).astype(jnp.float32))
    bn = R.BatchNorm2d(c).eval()
    bn.load_state_dict({
        "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
        "running_mean": torch.from_numpy(mean),
        "running_var": torch.from_numpy(sigma ** 2),
        "num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = R.conv_bn(conv, bn, xt)
        rounded = bn(conv(xt)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    return tuple(t.float().permute(0, 2, 3, 1).numpy()
                 for t in (got, rounded)) + (want,)


def test_eval_conv_bn_bf16_is_jitted_flax():
    """A conv and its BN in eval mode: jitted flax hands BN the conv's
    float32 result (XLA's fusion), and so does the port's ``conv_bn``;
    rounding the conv's output first misses by hundreds of ulps where the
    subtraction cancels."""
    got, rounded, want = conv_bn_case(transposed=False)
    assert np.all(np.abs(got - want) <= bf16_ulp(want))
    assert np.max(np.abs(rounded - want) / bf16_ulp(want)) > 100


def test_eval_conv_transpose_bn_bf16_is_jitted_flax():
    """The same for pix2pix's transposed conv and its BN: XLA fuses that
    pair too (JAX ``layers.py::ConvTranspose`` is one convolution)."""
    got, rounded, want = conv_bn_case(transposed=True)
    assert np.all(np.abs(got - want) <= bf16_ulp(want))
    assert np.max(np.abs(rounded - want) / bf16_ulp(want)) > 100


# ------------------------------------------- (b), (c) eval-mode forwards


@functools.lru_cache(maxsize=None)
def encoder_case(seed: int, offset: float) -> tuple:
    """(port's, JAX's) bf16 distance to the port's float64 forward of the
    thin encoder (JAX's fresh init for ``seed``), calibrated to its
    batch."""
    x = offset + np.random.default_rng(seed).standard_normal(
        (4, 64, 64, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    sd = calibrate(R.init_weights(R.ModifiedResNet(**GEOM), seed), xt)
    ref = forward(R.ModifiedResNet(compute_dtype=torch.float64,
                                   **GEOM).double(), sd, xt)
    got = forward(R.ModifiedResNet(compute_dtype=torch.bfloat16, **GEOM),
                  sd, xt)
    params, stats = TP.port_modified_resnet(numpy_sd(sd), LAYERS)
    model = FlaxResNet(dtype=jnp.bfloat16, **GEOM)
    want = strict("encoder", lambda v, x: model.apply(v, x, train=False),
                  {"params": params, "batch_stats": stats}, x)
    return rel(got, ref), rel(np.asarray(want), ref)


@functools.lru_cache(maxsize=None)
def generator_case(seed: int, offset: float) -> tuple:
    """The same for the thin pix2pix ResnetGenerator (batch norm, JAX's G
    init for ``--seed``) at 64 px, against jitted JAX."""
    x = offset + np.random.default_rng(seed).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))

    def net(dtype=None):
        return PP.ResnetGenerator(3, 1, NGF, BLOCKS, "batch", dtype=dtype)

    g = net()
    g.load_state_dict(FF.pix2pix(FF.pix2pix_keys(seed)[0], g))
    sd = calibrate(g, xt)
    ref = forward(net(torch.float64).double(), sd, xt)
    got = forward(net(torch.bfloat16), sd, xt)
    params, stats = TP.port_resnet_generator(numpy_sd(sd), BLOCKS)
    model = JP.ResnetGenerator(1, NGF, BLOCKS, "batch", False, jnp.bfloat16)
    want = jitted("generator", lambda v, x: model.apply(v, x, train=False),
                  {"params": params, "batch_stats": stats}, x)
    return rel(got, ref), rel(np.asarray(want).transpose(0, 3, 1, 2), ref)


INCEPTION_CLASSES = 10


def inception_to_flax(sd: dict) -> dict:
    """The port's InceptionV3 state dict (no ``AuxLogits``) -> flax's
    variables: the inverse of ``port_weights.inception_v3_from_flax``."""
    params, stats = {}, {}

    def basic(prefix, tree_p, tree_s, name):
        tree_p[name] = {
            "Conv_0": {"kernel": sd[f"{prefix}.conv.weight"].transpose(
                2, 3, 1, 0)},
            "BatchNorm_0": {"scale": sd[f"{prefix}.bn.weight"],
                            "bias": sd[f"{prefix}.bn.bias"]}}
        tree_s[name] = {"BatchNorm_0": {
            "mean": sd[f"{prefix}.bn.running_mean"],
            "var": sd[f"{prefix}.bn.running_var"]}}

    for i, (name, *_) in enumerate(PI.STEM):
        basic(name, params, stats, f"BasicConv2d_{i}")
    seen = {}
    for name, block, args in PI.MIXED:
        kind = block.__name__
        flax_name = f"{kind}_{seen.get(kind, 0)}"
        seen[kind] = seen.get(kind, 0) + 1
        params[flax_name], stats[flax_name] = {}, {}
        with torch.device("meta"):
            children = [n for n, _ in block(*args).named_children()]
        for j, child in enumerate(children):
            basic(f"{name}.{child}", params[flax_name], stats[flax_name],
                  f"BasicConv2d_{j}")
    params["fc"] = {"kernel": sd["fc.weight"].T, "bias": sd["fc.bias"]}
    return {"params": params, "batch_stats": stats}


@functools.lru_cache(maxsize=None)
def inception_case(seed: int, offset: float) -> tuple:
    """The same for InceptionV3 (JAX's init for ``seed``, its logits and
    the Mixed_6c features) at 75 px, the whole model cast to bf16 on both
    sides, against jitted JAX. The statistics are those of 16 images, the
    first 2 of which go through: at 75 px the last blocks' maps are 1x1,
    and the statistics of 2 images there would leave the float32 forward
    itself 9% from float64 (1.4e-5 with 16)."""
    x = offset + np.random.default_rng(seed).standard_normal(
        (16, 75, 75, 3)).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))

    def net():
        return PI.InceptionV3(INCEPTION_CLASSES, every_feat=True)

    m = net()
    m.load_state_dict(FF.inception_v3(seed, INCEPTION_CLASSES, aux=False))
    sd = calibrate(m, xt)
    x, xt = x[:2], xt[:2]
    ref = forward(net().double(), sd, xt.double())
    got = forward(net().to(torch.bfloat16), sd, xt.to(torch.bfloat16))
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                               inception_to_flax(numpy_sd(sd)))
    model = JI.InceptionV3(INCEPTION_CLASSES, every_feat=True)
    logits, feat = jitted("inception",
                          lambda v, x: model.apply(v, x, train=False), v,
                          jnp.asarray(x, jnp.bfloat16))
    want = flat((np.asarray(logits.astype(jnp.float32)),
                 np.asarray(feat.astype(jnp.float32)).transpose(0, 3, 1, 2)))
    return rel(got, ref), rel(want, ref)


CASE_FNS = {"encoder": encoder_case, "generator": generator_case,
            "inception": inception_case}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}-x{c[1]:g}")
@pytest.mark.parametrize("net", sorted(CASE_FNS))
def test_eval_bf16_distance_is_jax(net, case):
    port, jax_ = CASE_FNS[net](*case)
    assert port <= CASE_BOUND * jax_, (port, jax_, port / jax_)


@pytest.mark.parametrize("net", sorted(CASE_FNS))
def test_eval_bf16_distance_is_jax_on_the_mean(net):
    ratios = [p / j for p, j in map(lambda c: CASE_FNS[net](*c), CASES)]
    assert np.mean(ratios) <= MEAN_BOUND, ratios


# ------------------------------------------------- (d) one bf16 train step


TRIPLET = dict(margin=0.2, loss_type="euclidean", classification_weight=0.0,
               classification_weight2=0.0, num_heads=0)


def _port_step(geom: dict, sd: dict, batch: dict,
               dtype: torch.dtype) -> tuple:
    """The loss and the gradients of one train-mode triplet step."""
    model = R.ModifiedResNet(compute_dtype=dtype, **geom)
    if dtype == torch.float64:
        model.double()
    model.load_state_dict(sd)
    model.train()
    s, p, n = PT.forward3(model, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    loss = PL.triplet_loss_with_heads(PL.TripletLossConfig(**TRIPLET), s, p,
                                      n, None, None)["loss"]
    loss.backward()
    return float(loss.detach()), {k: m.grad.double().numpy()
                         for k, m in model.named_parameters()}


def train_step_distances(seed: int, geom: dict = GEOM, b: int = 3,
                         excess_precision: bool = False) -> dict:
    """One bf16 step from JAX's fresh init for ``seed`` (BN statistics 0
    and 1, so train mode normalizes by the batch), three modalities of
    ``b`` images (the sketches offset by 3): the port's and JAX's
    distances to the port's float64 step, of the loss (absolute) and of
    the gradient (relative L2 over every parameter)."""
    res = geom["input_resolution"]
    rng = np.random.default_rng(10 + seed)
    batch = {k: (off + rng.standard_normal((b, res, res, 3))).astype(
        np.float32) for k, off in (("sketch", 3.0), ("positive", 0.0),
                                   ("negative", 0.0))}
    sd = R.init_weights(R.ModifiedResNet(**geom), seed).state_dict()
    ref_loss, ref_g = _port_step(geom, sd, batch, torch.float64)
    loss, grads = _port_step(geom, sd, batch, torch.bfloat16)

    layers = geom["layers"]
    params, stats = TP.port_modified_resnet(numpy_sd(sd), layers)
    model = FlaxResNet(dtype=jnp.bfloat16, **geom)
    cfg = JL.TripletLossConfig(**TRIPLET)

    def step(params, stats, batch):
        def loss_fn(p):
            (s, po, n), _ = JT._forward3(model.apply, p, stats, batch,
                                         train=True)
            return JL.triplet_loss_with_heads(cfg, s, po, n, None,
                                              None)["loss"]
        return jax.value_and_grad(loss_fn)(params)

    if excess_precision:
        jloss, jgrads = jax.jit(step)(params, stats, batch)
    else:
        jloss, jgrads = strict(f"step{sorted(geom.items())}{b}", step,
                               params, stats, batch)
    jgrads = PW.modified_resnet_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads), stats, layers)
    flat = lambda g: np.concatenate(  # noqa: E731
        [np.asarray(g[k], np.float64).ravel() for k in sorted(ref_g)])
    return {"loss": abs(loss - ref_loss),
            "jax_loss": abs(float(jloss) - ref_loss),
            "grad": rel(flat(grads), flat(ref_g)),
            "jax_grad": rel(flat(jgrads), flat(ref_g)),
            "float64_loss": ref_loss}


@pytest.mark.parametrize("seed", [0, 1])
def test_train_step_bf16_distance_is_jax(seed):
    d = train_step_distances(seed)
    assert d["loss"] <= CASE_BOUND * d["jax_loss"], d
    assert d["grad"] <= CASE_BOUND * d["jax_grad"], d


def ci_rank_study(root) -> dict:
    """The ``ci`` preset (one thread, as its golden) on the CPU, then its
    trained model's test catalog embedded four ways: the port in bf16, in
    float64, in bf16 with the old fold of BN into bf16, and JAX's flax
    encoder in bf16 on the same weights, compiled with XLA's default and
    with excess precision off. Each way's rank histogram (queries within
    the top k, k = 1..10) and its gallery and query embeddings' relative
    distance to float64's."""
    import copy
    import glob
    import os
    from pathlib import Path

    from art_sbir_tpu.models.resnet import (
        ModifiedResNetWithClassification as FlaxResNetCls)
    from art_sbir_tpu_torch.cli import goldens as G
    from art_sbir_tpu_torch.core.results import load_results
    from art_sbir_tpu_torch.retrieval import engine as E
    from art_sbir_tpu_torch.train.prepare import finish_gallery_batch

    from art_sbir_tpu_torch.cli import train as train_cli

    root = Path(root)
    os.chdir(root)  # cli/train.py exports models/<run>.pt
    G.pin_ci_environment()
    call = {}

    def run_inference(forward_fn, dataset, *args, **kw):
        call.update(dataset=dataset, args=args, kw=kw)
        return E.run_inference(forward_fn, dataset, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:  # the CLI's own test catalog
        mp.setattr(train_cli, "run_inference", run_inference)
        G.run("ci", root / "data", root / "results", seed=0, device="cpu")
    run = Path(glob.glob(str(root / "results" / "*"))[0]).name
    params = load_results(root / "results" / run)["training_params"]
    model, restored = E.restore_encoder(run, params, root / "models",
                                        torch.device("cpu"))
    assert restored
    m64 = copy.deepcopy(model).double()
    m64.compute_dtype = torch.float64
    sd = numpy_sd(model.state_dict())
    heads = model.classifier.out_features
    jparams, jstats = TP.port_modified_resnet_with_classification(
        sd, tuple(params["layers"]), num_classes=heads)
    flax_model = FlaxResNetCls(num_classes=heads, dtype=jnp.bfloat16,
                               input_resolution=params["image_size"],
                               width=params["width"],
                               layers=tuple(params["layers"]))
    v = {"params": jparams, "batch_stats": jstats}

    def jax_forward(strict_rounding):
        compiled = {}

        def fwd(u8):
            x = finish_gallery_batch(u8).numpy()
            if x.shape not in compiled:
                lowered = jax.jit(lambda v, x: flax_model.apply(
                    v, x, train=False)[0]).lower(v, x)
                compiled[x.shape] = lowered.compile(compiler_options={
                    "xla_allow_excess_precision": not strict_rounding})
            return torch.from_numpy(np.asarray(compiled[x.shape](v, x)))
        return fwd

    def fold(m, args, out):
        scale = m.weight * torch.rsqrt(m.running_var + m.eps)
        shift = m.bias - m.running_mean * scale
        return torch.addcmul(shift.to(out.dtype)[None, :, None, None],
                             args[0], scale.to(out.dtype)[None, :, None, None])

    def port(u8):
        with torch.no_grad():
            return model(finish_gallery_batch(u8))

    ways = {"port_bf16": port,
            "port_float64": lambda u8: m64(finish_gallery_batch(u8).double()),
            "jax_bf16_xla_default": jax_forward(False),
            "jax_bf16_op_by_op": jax_forward(True),
            "port_bf16_old_fold": port}
    seen = {}
    for name, fwd in ways.items():
        old = name.endswith("old_fold")
        hooks = ([m.register_forward_hook(fold) for m in model.modules()
                  if isinstance(m, R.BatchNorm2d)] if old else [])
        trace = {}
        with pytest.MonkeyPatch.context() as mp:
            if old:  # the conv's output rounded to bf16 before BN, too
                mp.setattr(R, "conv_bn",
                           lambda conv, bn, x: bn(conv(x).to(x.dtype)))
            d = E.run_inference(fwd, call["dataset"], *call["args"], **{
                **call["kw"], "save_features": False, "trace": trace})
        for h in hooks:
            h.remove()
        queries = np.concatenate([p["queries"].double().numpy()
                                  for p in trace["passes"]])
        seen[name] = (trace["gallery"].double().numpy(), queries,
                      [round(a * len(queries)) for a in d["topk_acc"]])
    g64, q64, _ = seen["port_float64"]
    return {name: {"ranks_within_k": h, "gallery_to_float64": rel(g, g64),
                   "queries_to_float64": rel(q, q64)}
            for name, (g, q, h) in seen.items()}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bf16_parity.py
    #   [step | eval | ci DIR]
    # step: the train step at the flagship's width and depth (64 px, 3
    # images a modality); eval: each case of (b) and (c) against JAX
    # compiled both ways; ci: ci_rank_study in DIR
    import json
    import sys

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)  # as the tests run
    what = sys.argv[1] if len(sys.argv) > 1 else "step"
    if what == "step":
        flagship = dict(layers=(3, 4, 6, 3), output_dim=1024, heads=32,
                        input_resolution=64, width=64)
        for seed in (0, 1):
            for excess in (False, True):
                d = train_step_distances(seed, flagship, 3, excess)
                print(json.dumps({"seed": seed, "excess_precision": excess,
                                  **d}))
    elif what == "eval":
        # the port as it is; with the bf16 conv's output rounded before BN,
        # and with the old fold of BN into bf16 as well
        # (yardsticks); each against JAX op by op, then jitted with XLA's
        # default
        eval_bn, fused, op_by_op = R.BatchNorm2d.forward, R.conv_bn, strict

        def rounded(conv, bn, x):
            return bn(conv(x).to(x.dtype))

        def old_fold(self, x):
            if self.training or x.dtype != torch.bfloat16:
                return eval_bn(self, x)
            scale = self.weight * torch.rsqrt(self.running_var + self.eps)
            shift = self.bias - self.running_mean * scale
            return torch.addcmul(shift.to(x.dtype)[None, :, None, None], x,
                                 scale.to(x.dtype)[None, :, None, None])

        ways = {"port": (fused, eval_bn), "conv_rounded": (rounded, eval_bn),
                "old_fold": (rounded, old_fold)}
        for jax_op_by_op in (True, False):
            strict = jitted = op_by_op if jax_op_by_op else (
                lambda name, fn, *args: jax.jit(fn)(*args))
            for port, (R.conv_bn, R.BatchNorm2d.forward) in ways.items():
                _COMPILED.clear()
                for net, fn in CASE_FNS.items():
                    fn.cache_clear()
                    ratios = [p / j for p, j in map(lambda c: fn(*c), CASES)]
                    print(json.dumps({"net": net, "port": port,
                                      "jax_op_by_op": jax_op_by_op,
                                      "ratios": ratios, "max": max(ratios),
                                      "mean": float(np.mean(ratios))}))
    else:
        print(json.dumps(ci_rank_study(sys.argv[2]), indent=1))
