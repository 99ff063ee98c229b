"""The forward-only generators of the port against the JAX package, on the
CPU: the shared layers (reflection padding, instance norm, the transposed
conv's geometry), ``DrawingGenerator`` and ``GlobalGenerator2``, the AdaIN
ops and networks, dilation, and the weight carriers and ``.pth`` loaders.

The same numpy-seeded inputs and weights go through both: weights numpy ->
flax through ``torch_port.port_*`` and numpy -> port through
``load_state_dict``. The port is NCHW and JAX NHWC; inputs are transposed
on the way in. Float32 tolerances are stated in each test: the two
packages' convolutions and reductions sum in other orders, so agreement is
to float32 rounding, not bit for bit; dilation is exact arithmetic and is
held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from art_sbir_tpu.models import adain_net as JA
from art_sbir_tpu.models import drawing as JD
from art_sbir_tpu.models import layers as JL
from art_sbir_tpu.models import torch_port as TP
from art_sbir_tpu.ops import adain as JOA
from art_sbir_tpu.ops import dilate as JDL
from art_sbir_tpu_torch.models import adain_net as PA
from art_sbir_tpu_torch.models import drawing as PD
from art_sbir_tpu_torch.models import layers as PL
from art_sbir_tpu_torch.models import port_weights as PW
from art_sbir_tpu_torch.models.resnet import BatchNorm2d
from art_sbir_tpu_torch.ops import adain as POA
from art_sbir_tpu_torch.ops import dilate as PDL


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def random_state_dict(model: nn.Module, rng, bn: bool = False) -> dict:
    """Numpy-seeded weights for every entry of ``model``'s state dict:
    conv weights N(0, 2 / fan_in) (activations keep their scale through
    the depth), biases N(0, 0.1); with ``bn`` BatchNorm affine N(1, 0.1) /
    N(0, 0.1), running mean N(0, 0.1) and var U(0.5, 1.5)."""
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
            continue
        if k.endswith("weight") and v.ndim == 4:
            mod = model.get_submodule(k.rsplit(".", 1)[0])
            fan_in = (v.shape[1] if isinstance(mod, nn.Conv2d)
                      else v.shape[0]) * v.shape[2] * v.shape[3]
            a = rng.standard_normal(v.shape) * np.sqrt(2.0 / fan_in)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("weight"):  # BatchNorm scale
            a = 1.0 + 0.1 * rng.standard_normal(v.shape)
        else:
            a = 0.1 * rng.standard_normal(v.shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    assert bn or not any("running" in k for k in sd)
    return sd


def numpy_sd(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("shape,pad", [((2, 5, 7, 3), 2), ((1, 9, 4, 2), 3)])
def test_reflect_pad_matches_jax(rng, shape, pad):
    x = rng.standard_normal(shape).astype(np.float32)
    got = nhwc(PL.reflect_pad(nchw(x), pad))
    np.testing.assert_array_equal(got, np.asarray(JL.reflect_pad(x, pad)))


def test_instance_norm_float32_matches_jax(rng):
    """rtol/atol 1e-5: the same statistics, summed in another order. A
    float64 input stays float64 (the float64 yardstick of
    ``chip_smoke.py``)."""
    x = (3.0 * rng.standard_normal((2, 9, 7, 5)) + 1.5).astype(np.float32)
    got = nhwc(PL.instance_norm(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(JL.instance_norm(x)),
                               rtol=1e-5, atol=1e-5)
    wide = PL.instance_norm(nchw(x).double())
    assert wide.dtype == torch.float64
    np.testing.assert_allclose(nhwc(wide), got, rtol=1e-5, atol=1e-5)


def test_instance_norm_bf16_takes_float32_statistics(rng):
    """A bf16 input: the statistics and the normalization in float32, the
    result rounded once to bf16, exactly; JAX's within one bf16 step
    (its float32 sums take another order, which can move a rounding)."""
    x = (3.0 * rng.standard_normal((2, 16, 12, 4)) + 1.5).astype(np.float32)
    xb = nchw(x).to(torch.bfloat16)
    got = PL.instance_norm(xb)
    assert got.dtype == torch.bfloat16
    want = PL.instance_norm(xb.float()).to(torch.bfloat16)
    assert torch.equal(got, want)
    jx = JL.instance_norm(jnp.asarray(x).astype(jnp.bfloat16))
    jx = np.asarray(jx.astype(jnp.float32))
    got32 = nhwc(got.float())
    step = 2.0 ** -7 * np.maximum(np.abs(jx), 2.0 ** -10)
    assert np.all(np.abs(got32 - jx) <= step)


@pytest.mark.parametrize("k,s,p,op,size", [(3, 2, 1, 1, 7), (3, 2, 1, 1, 8),
                                           (4, 2, 1, 0, 5)])
def test_conv_transpose_geometry_matches_jax(rng, k, s, p, op, size):
    """``nn.ConvTranspose2d`` against JAX's hand-built torch geometry, the
    weight carried (in, out, kh, kw) -> (kh, kw, out, in); atol 1e-5."""
    cin, cout = 6, 5
    x = rng.standard_normal((2, size, size + 1, cin)).astype(np.float32)
    w = rng.standard_normal((cin, cout, k, k)).astype(np.float32) * 0.3
    b = rng.standard_normal(cout).astype(np.float32)
    mod = nn.ConvTranspose2d(cin, cout, k, stride=s, padding=p,
                             output_padding=op)
    mod.load_state_dict({"weight": torch.from_numpy(w),
                         "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = nhwc(mod(nchw(x)))
    want = np.asarray(JL.torch_conv_transpose(
        x, TP.conv_transpose_kernel(w), s, p, op, b))
    assert got.shape == want.shape == (2, (size - 1) * s - 2 * p + k + op,
                                       size * s - 2 * p + k + op, cout)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_torch_default_init_is_seeded():
    """The generators' fresh init (``flax_init``, the JAX package's
    distributions) is a function of the seed alone."""
    a = PL.flax_init(PD.DrawingGenerator(), seed=0).state_dict()
    b = PL.flax_init(PD.DrawingGenerator(), seed=0).state_dict()
    c = PL.flax_init(PD.DrawingGenerator(), seed=1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model0.1.weight"], c["model0.1.weight"])
    # flax's truncated lecun normal: |w| <= 2 / 0.8796 / sqrt(fan_in)
    bound = 2.0 / PL.TRUNC_NORMAL_STD / np.sqrt(3 * 49)
    assert float(a["model0.1.weight"].abs().max()) <= bound


# ------------------------------------------------------------------ drawing


@pytest.mark.parametrize("size", [36])
def test_drawing_generator_matches_jax(rng, size):
    """Reference-layout weights into both; atol 1e-5 on the sigmoid's
    output (3 residual blocks, 256 channels)."""
    port = PD.DrawingGenerator()
    sd = random_state_dict(port, rng)
    port.load_state_dict(sd)
    assert set(sd) == set(PD.DrawingGenerator().state_dict())
    x = rng.random((2, size, size, 3)).astype(np.float32)
    model = JD.DrawingGenerator()
    params = TP.port_drawing_generator(numpy_sd(sd))
    want = np.asarray(model.apply({"params": params}, x))
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    assert got.shape == (2, size, size, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _flax_names(model: nn.Module):
    """(port module name, flax auto-name) of every conv, transposed conv and
    BatchNorm, in creation order: flax counts each type on its own."""
    kinds = {nn.Conv2d: "Conv", nn.ConvTranspose2d: "ConvTranspose",
             BatchNorm2d: "BatchNorm"}
    counts = dict.fromkeys(kinds.values(), 0)
    for name, mod in model.named_modules():
        flax = kinds.get(type(mod))
        if flax is not None:
            yield name, f"{flax}_{counts[flax]}"
            counts[flax] += 1


def test_global_generator2_matches_jax_in_eval_mode(rng):
    """ngf 4, one block, three transposed-conv 'downs' (5 px in, 448 px
    out), random BatchNorm statistics; eval mode; atol 1e-5 on the tanh."""
    port = PD.GlobalGenerator2(ngf=4, n_blocks=1).eval()
    sd = random_state_dict(port, rng, bn=True)
    port.load_state_dict(sd)
    params, stats = {}, {}
    for name, flax in _flax_names(port):
        if flax.startswith("BatchNorm"):
            params[flax] = {"scale": sd[f"{name}.weight"].numpy(),
                            "bias": sd[f"{name}.bias"].numpy()}
            stats[flax] = {"mean": sd[f"{name}.running_mean"].numpy(),
                           "var": sd[f"{name}.running_var"].numpy()}
        else:
            params[flax] = {"kernel": sd[f"{name}.weight"].numpy().transpose(
                2, 3, 1, 0), "bias": sd[f"{name}.bias"].numpy()}
    x = rng.random((1, 5, 5, 3)).astype(np.float32)
    model = JD.GlobalGenerator2(ngf=4, n_blocks=1)
    init = jax.eval_shape(model.init, jax.random.key(0), x)
    assert jax.tree_util.tree_structure(init["params"]) == \
        jax.tree_util.tree_structure(params)
    want = np.asarray(model.apply({"params": params, "batch_stats": stats},
                                  x, train=False))
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    assert got.shape == want.shape == (1, 448, 448, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------------------------------------------ AdaIN ops


def test_calc_mean_std_matches_jax(rng):
    """Unbiased variance plus eps, then the root; rtol 1e-5."""
    x = (2.0 * rng.standard_normal((2, 7, 9, 5)) + 0.5).astype(np.float32)
    mean, std = POA.calc_mean_std(nchw(x))
    jm, js = JOA.calc_mean_std(x)
    assert mean.shape == std.shape == (2, 5, 1, 1)
    np.testing.assert_allclose(nhwc(mean), np.asarray(jm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(nhwc(std), np.asarray(js), rtol=1e-5)
    var = torch.var(nchw(x).reshape(2, 5, -1), dim=2)  # torch's default
    np.testing.assert_allclose(std[:, :, 0, 0].numpy() ** 2,
                               var.numpy() + 1e-5, rtol=1e-5)


def test_adaptive_instance_normalization_matches_jax(rng):
    """rtol 1e-5, atol 1e-5 (the style's scale is about 5)."""
    c = rng.standard_normal((2, 8, 6, 4)).astype(np.float32)
    s = (3.0 * rng.standard_normal((2, 5, 7, 4)) + 5.0).astype(np.float32)
    got = nhwc(POA.adaptive_instance_normalization(nchw(c), nchw(s)))
    want = np.asarray(JOA.adaptive_instance_normalization(c, s))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_coral_matches_jax(rng):
    """Square roots by SVD: the singular vectors' signs may differ between
    the libraries, their product not; rtol 1e-4, atol 1e-5."""
    src = rng.random((16, 12, 3)).astype(np.float32)
    tgt = (0.5 * rng.random((16, 12, 3)) + 0.25).astype(np.float32)
    got = POA.coral(torch.from_numpy(src.transpose(2, 0, 1).copy()),
                    torch.from_numpy(tgt.transpose(2, 0, 1).copy()))
    want = np.asarray(JOA.coral(src, tgt))
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), want,
                               rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ AdaIN nets


@pytest.fixture(scope="module")
def adain_weights():
    """The port's networks with numpy-seeded reference-layout weights, and
    the same weights as flax trees (through ``torch_port.port_adain``)."""
    rng = np.random.default_rng(7)
    enc, dec = PA.AdaINEncoder().eval(), PA.AdaINDecoder().eval()
    esd, dsd = random_state_dict(enc, rng), random_state_dict(dec, rng)
    enc.load_state_dict(esd)
    dec.load_state_dict(dsd)
    ported = TP.port_adain(numpy_sd(esd), numpy_sd(dsd))
    return enc, dec, ported["encoder"], ported["decoder"]


def test_adain_keys_are_the_published_indices(adain_weights):
    enc, dec = adain_weights[:2]
    assert sorted({int(k.split(".")[0]) for k in enc.state_dict()}) == \
        list(PW.ADAIN_ENCODER_CONVS)
    assert sorted({int(k.split(".")[0]) for k in dec.state_dict()}) == \
        list(PW.ADAIN_DECODER_CONVS)


def jax_relu_x_1(ep, x):
    """relu1_1, relu2_1, relu3_1 and relu4_1 of the JAX encoder: the ReLUs
    of its convs 0, 2, 4 and 8. Its own ``capture=True`` takes conv 6
    (relu3_3) for relu3_1 (``adain_net.py:31``, ``_STAGE_ENDS = (1, 3, 7,
    9)``); the reference's ``enc_3`` ends at relu3_1 (`net.py`
    ``enc_layers[11:18]``), and the port follows the reference (ROADMAP.md
    section 3)."""
    _, state = JA.AdaINEncoder().apply({"params": ep}, x,
                                       capture_intermediates=True,
                                       mutable=["intermediates"])
    inter = state["intermediates"]
    return [jax.nn.relu(inter[f"conv{i}"]["__call__"][0])
            for i in (0, 2, 4, 8)]


@pytest.mark.parametrize("size", [(36, 44)])
def test_adain_encoder_matches_jax(rng, adain_weights, size):
    """Through relu4_1 and the four relu*_1 captures (36 px pools to 18,
    9, 4: both packages floor); rtol 1e-4, atol 1e-4 of activations about
    1. JAX's own third capture is relu3_3, the port's activation after
    Sequential index 23."""
    enc, _, ep, _ = adain_weights
    x = rng.random((2, *size, 3)).astype(np.float32)
    want = jax_relu_x_1(ep, x)
    with torch.no_grad():
        got = enc(nchw(x), capture=True)
        last = enc(nchw(x))
        relu3_3 = nn.Sequential(*list(enc)[:24])(nchw(x))
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    assert torch.equal(last, got[-1])
    jax_own = JA.AdaINEncoder().apply({"params": ep}, x, capture=True)
    np.testing.assert_allclose(nhwc(relu3_3), np.asarray(jax_own[2]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw", [(5, 3)])
def test_adain_decoder_matches_jax(rng, adain_weights, hw):
    """Nearest 2x upsampling on even and odd feature sizes; rtol 1e-4,
    atol 1e-4."""
    _, dec, _, dp = adain_weights
    t = np.abs(rng.standard_normal((2, *hw, 512))).astype(np.float32)
    want = np.asarray(JA.AdaINDecoder().apply({"params": dp}, t))
    with torch.no_grad():
        got = nhwc(dec(nchw(t)))
    assert got.shape == (2, 8 * hw[0], 8 * hw[1], 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_style_transfer_and_losses_match_jax(rng, adain_weights, alpha):
    """``style_transfer`` at rtol 1e-4, atol 1e-4; ``adain_losses`` at
    rtol 1e-4, JAX's given the reference's relu*_1 captures
    (:func:`jax_relu_x_1`)."""
    enc, dec, ep, dp = adain_weights
    c = rng.random((2, 32, 32, 3)).astype(np.float32)
    s = rng.random((2, 32, 32, 3)).astype(np.float32)
    je, jd = JA.AdaINEncoder(), JA.AdaINDecoder()

    def eapply(x):
        return je.apply({"params": ep}, x)

    def ecap(x):
        return jax_relu_x_1(ep, x)

    def dapply(t):
        return jd.apply({"params": dp}, t)

    want = np.asarray(JA.style_transfer(eapply, dapply, c, s, alpha))
    with torch.no_grad():
        got = nhwc(PA.style_transfer(enc, dec, nchw(c), nchw(s), alpha))
        lc, ls = PA.adain_losses(enc, dec, nchw(c), nchw(s), alpha)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    jc, js = JA.adain_losses(ecap, dapply, c, s, alpha)
    np.testing.assert_allclose(float(lc), float(jc), rtol=1e-4)
    np.testing.assert_allclose(float(ls), float(js), rtol=1e-4)


# ------------------------------------------------------------------ dilate


@pytest.mark.parametrize("shape", [(17, 23), (3, 9, 14)])
def test_binary_dilate_cross_matches_jax(rng, shape):
    img = (rng.random(shape) > 0.85).astype(np.float32)
    got = PDL.binary_dilate_cross(torch.from_numpy(img))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JDL.binary_dilate_cross(img)))


@pytest.mark.parametrize("ksize", [2, 3, 4, 5])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int32])
def test_dilate_maxpool_matches_jax(rng, ksize, dtype):
    """cv2's anchor (even ksize pads (k//2, k-1-k//2)), replicated borders,
    odd sizes, batched; exact. JAX's ``dilate_maxpool`` refuses integer
    input (its ``reduce_window`` init value is an int32 whatever the
    operand's type; its only caller, ``dilate_binarize``, passes float32),
    so integer images are held against JAX on their float32 values, which
    hold them exactly (|v| < 2^24)."""
    shape = (2, 13, 19)
    if dtype == np.float32:
        img = rng.standard_normal(shape).astype(dtype)
    elif dtype == np.int32:
        img = rng.integers(-2 ** 24, 2 ** 24, shape).astype(dtype)
    else:
        img = rng.integers(0, 256, shape).astype(dtype)
    got = PDL.dilate_maxpool(torch.from_numpy(img), ksize)
    want = np.asarray(JDL.dilate_maxpool(jnp.asarray(img, jnp.float32),
                                         ksize)).astype(dtype)
    assert got.dtype == torch.from_numpy(img).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        PDL.dilate_maxpool(torch.from_numpy(img[0]), ksize).numpy(), want[0])


@pytest.mark.parametrize("shape", [(31, 27), (40, 40)])
def test_dilate_binarize_matches_jax(rng, shape):
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[rng.random(shape) > 0.97] = 251  # values at the threshold's edge
    img[rng.random(shape) > 0.97] = 250
    got = PDL.dilate_binarize(torch.from_numpy(img))
    want = np.asarray(JDL.dilate_binarize(jnp.asarray(img)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) <= {0, 255}


# ------------------------------------------------------------------ weights


def test_drawing_from_flax_on_a_jax_init(rng):
    """A JAX init carried into the port with ``load_state_dict`` (strict):
    the same drawings, atol 1e-5; and back through
    ``torch_port.port_drawing_generator`` to the same tree."""
    model = JD.DrawingGenerator()
    x = rng.random((1, 32, 32, 3)).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.key(3), x)["params"])
    sd = PW.drawing_from_flax(params)
    port = PD.DrawingGenerator().eval()
    port.load_state_dict(sd)
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(
        model.apply({"params": params}, x)), atol=1e-5)
    back = TP.port_drawing_generator(numpy_sd(sd))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_adain_from_flax_on_a_jax_init(rng):
    x = rng.random((1, 32, 32, 3)).astype(np.float32)
    je, jd = JA.AdaINEncoder(), JA.AdaINDecoder()
    ep = jax.tree_util.tree_map(
        np.asarray, jax.jit(je.init)(jax.random.key(0), x)["params"])
    feat = je.apply({"params": ep}, x)
    dp = jax.tree_util.tree_map(
        np.asarray, jax.jit(jd.init)(jax.random.key(1), feat)["params"])
    esd, dsd = PW.adain_from_flax(ep, dp)
    enc, dec = PA.AdaINEncoder().eval(), PA.AdaINDecoder().eval()
    enc.load_state_dict(esd)
    dec.load_state_dict(dsd)
    with torch.no_grad():
        got = nhwc(dec(enc(nchw(x))))
    want = np.asarray(jd.apply({"params": dp}, feat))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    back = TP.port_adain(numpy_sd(esd), numpy_sd(dsd))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           {"encoder": ep, "decoder": dp})


def _full_vgg_normalised() -> nn.Sequential:
    """The published ``vgg_normalised`` layout through relu5_4 (indices
    0..52): the port's encoder, then relu4_2..relu5_4."""
    layers = list(PA.AdaINEncoder())
    for i in range(7):
        if i == 3:
            layers.append(nn.MaxPool2d(2, 2))
        layers += [nn.ReflectionPad2d(1), nn.Conv2d(512, 512, 3), nn.ReLU()]
    return nn.Sequential(*layers)


def test_adain_loader_drops_keys_past_relu4_1(tmp_path, capsys):
    """``vgg_normalised.pth`` through relu5_4: the keys past relu4_1 are
    dropped by index, the rest load strictly; a directory and a
    comma-joined pair give the same; a whole pickled module is unwrapped;
    a key the file lacks keeps its init and is named; a key the model
    lacks raises."""
    vgg = _full_vgg_normalised()
    assert max(int(k.split(".")[0]) for k in vgg.state_dict()) == 51
    dec = PL.flax_init(PA.AdaINDecoder(), seed=5)
    torch.save(vgg.state_dict(), tmp_path / "vgg_normalised.pth")
    torch.save(dec, tmp_path / "decoder.pth")  # a whole module
    enc_sd, dec_sd = PW.load_adain_pth(str(tmp_path))
    assert set(enc_sd) == set(PA.AdaINEncoder().state_dict())
    assert set(dec_sd) == set(dec.state_dict())
    pair = PW.load_adain_pth(f"{tmp_path / 'vgg_normalised.pth'},"
                             f"{tmp_path / 'decoder.pth'}")
    for a, b in zip((enc_sd, dec_sd), pair):
        assert all(torch.equal(a[k], b[k]) for k in a)
    enc = PW.load_into(PA.AdaINEncoder(), enc_sd, "encoder")
    assert torch.equal(enc.state_dict()["29.weight"],
                       vgg.state_dict()["29.weight"])
    assert capsys.readouterr().err == ""

    fresh = PA.AdaINEncoder()
    before = fresh.state_dict()["2.bias"].clone()
    partial = {k: v for k, v in enc_sd.items() if k != "2.bias"}
    PW.load_into(fresh, partial, "encoder")
    assert torch.equal(fresh.state_dict()["2.bias"], before)
    assert "2.bias" in capsys.readouterr().err
    with pytest.raises(KeyError, match="not in the model"):
        PW.load_into(PA.AdaINEncoder(), vgg.state_dict(), "encoder")
