"""The port's pix2pix networks and G+D trainer against the JAX package's, on
the CPU, at thin shapes (``ngf`` = ``ndf`` = 8, two residual blocks, a
U-Net of 6 downs, 32-64 px).

Weights are a flax tree, numpy-seeded values in the shapes of the flax
init (the trainer's tests take ``Pix2Pix``'s own init), carried into the
port by ``models/port_weights.py::pix2pix_*_from_flax``; inputs are
numpy-seeded.
The port is NCHW and JAX NHWC; inputs are transposed on the way in.

* Forwards (every generator, discriminator and norm, eval and train mode,
  the running statistics after a train-mode forward) at rtol 1e-4 with
  an absolute 1e-5: the two packages' float32 convolutions and
  reductions sum in other orders.
* A reference-layout state dict (the U-Net's from
  ``tests/test_torch_port_generators.py::_unet_sd``) loads into the port
  natively and gives JAX's output after JAX's ``port_*`` mapping.
* One G+D step with dropout off: losses at rtol 1e-5; running statistics
  at rtol 1e-4, absolute 1e-6 (a mean near 0 keeps its sum's absolute
  error); the Adam moments per tensor, ``||m_port - m_jax|| <= 1e-4
  ||m_jax||`` (twice that for the second moment, a square); and the
  parameters at rtol 1e-4 with an absolute 1e-4 * lr. Adam's first step
  is ``lr * g / (|g| + eps)``, about ``lr * sign(g)``: an element whose
  gradient lies within float noise of 0 moves by a step that noise
  decides, so such elements (|g| under 1e-5 of the tensor's largest, or
  every element of a tensor whose gradient is a norm's exact zero, under
  1e-6 of the net's largest: a bias that an instance norm removes) are
  held at 2 * lr, and their moments at that zero on both sides.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.models import pix2pix as JP
from art_sbir_tpu.models import torch_port as TP
from art_sbir_tpu.train import gan as JG
from art_sbir_tpu_torch.models import pix2pix as PP
from art_sbir_tpu_torch.models import port_weights as PW
from art_sbir_tpu_torch.train import gan as PG
from tests.test_torch_port_generators import _unet_sd
from tests.torch_threads import two_torch_threads  # noqa: F401

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
STATS_TOL = dict(rtol=1e-4, atol=1e-6)
MOMENT_RTOL = 1e-4
NGF, BLOCKS, DOWNS = 8, 2, 6


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flax_tree(model, x: np.ndarray, rng):
    """(variables, params, batch_stats) in the shapes of ``model``'s init
    (traced, not compiled), filled from ``rng``: kernels N(0, 1 / fan_in),
    biases N(0, 0.1), batch-norm scales N(1, 0.1), running means N(0,
    0.1) and variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.asarray(x),
                                                 train=False),
                            jax.random.key(0))

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(leaf.shape[:-1]))
            a = rng.standard_normal(leaf.shape) * np.sqrt(1.0 / fan_in)
        elif "scale" in name:
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif "'var'" in name:
            a = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return a.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v, v["params"], v.get("batch_stats", {})


def thin_g(side: str, net: str, norm: str, dropout: bool = False):
    """The thin generator of ``side`` ('jax' or 'port')."""
    if side == "jax":
        return (JP.ResnetGenerator(1, NGF, BLOCKS, norm, dropout)
                if net == "resnet_9blocks"
                else JP.UnetGenerator(1, DOWNS, NGF, norm, dropout))
    return (PP.ResnetGenerator(3, 1, NGF, BLOCKS, norm, dropout)
            if net == "resnet_9blocks"
            else PP.UnetGenerator(3, 1, DOWNS, NGF, norm, dropout))


def g_to_sd(net, params, stats):
    return PW.pix2pix_g_from_flax(net, params, stats, n_blocks=BLOCKS,
                                  num_downs=DOWNS)


def load(port, sd):
    own = port.state_dict()
    assert set(sd) <= set(own), sorted(set(sd) - set(own))
    missing = {k for k in set(own) - set(sd)
               if not k.endswith("num_batches_tracked")}
    assert not missing, sorted(missing)
    port.load_state_dict({**own, **sd})
    return port


def port_stats(net) -> dict:
    return {k: v.numpy() for k, v in net.state_dict().items()
            if "running_" in k}


def assert_stats(port_net, want_sd):
    got = port_stats(port_net)
    assert got.keys() == {k for k in want_sd if "running_" in k}
    for k, v in got.items():
        np.testing.assert_allclose(v, want_sd[k].numpy(), **STATS_TOL,
                                   err_msg=k)


def check_forward(jmodel, port, variables, x, sd_of):
    """Eval and train mode through both; the running statistics after the
    train-mode forward."""
    for train in (False, True):
        port.train(train)
        with torch.no_grad():
            got = nhwc(port(nchw(x)))
        if train:
            want, mut = jax.jit(lambda v, x: jmodel.apply(
                v, x, train=True, mutable=["batch_stats"]))(variables, x)
            assert_stats(port, sd_of(mut.get("batch_stats", {})))
        else:
            want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
                variables, x)
        np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)


# ---------------------------------------------------------------- networks


@pytest.mark.parametrize("net,norm,size", [
    ("resnet_9blocks", "batch", 32), ("resnet_9blocks", "instance", 32),
    ("unet_256", "batch", 64), ("unet_256", "none", 64)])
def test_generators_match_jax(rng, net, norm, size):
    x = rng.random((2, size, size, 3)).astype(np.float32)
    jmodel, port = thin_g("jax", net, norm), thin_g("port", net, norm)
    v, params, stats = flax_tree(jmodel, x, rng)
    load(port, g_to_sd(net, params, stats))
    check_forward(jmodel, port, v, x,
                  lambda s: g_to_sd(net, params, to_np(s)))


@pytest.mark.parametrize("net", ["basic", "n_layers", "pixel"])
@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_discriminators_match_jax(rng, net, norm):
    x = rng.random((2, 32, 32, 4)).astype(np.float32)
    jmodel, port = JP.define_d(net, NGF, 2, norm), PP.define_d(net, NGF, 2,
                                                               norm)
    v, params, stats = flax_tree(jmodel, x, rng)
    to_sd = lambda s: PW.pix2pix_d_from_flax(net, params, s, n_layers=2)  # noqa: E731
    load(port, to_sd(stats))
    check_forward(jmodel, port, v, x, lambda s: to_sd(to_np(s)))


@pytest.mark.parametrize("kind", ["batch", "instance", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches_jax(rng, kind, dtype):
    """Train-mode ``Norm`` on bf16 or float32 input: the output in the
    input's dtype and, for batch norm, the float32 running statistics
    (both packages take the statistics in float32)."""
    c = 6
    x = (2.0 * rng.standard_normal((3, 5, 5, c)) + 0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmodel = JP.Norm(kind, jdt)
    v = jmodel.init(jax.random.key(2), jnp.asarray(x, jdt), train=False)
    port = PP.norm_layer(kind, c).train()
    if kind == "batch":
        port.load_state_dict({"weight": torch.from_numpy(
            np.asarray(v["params"]["BatchNorm_0"]["scale"])),
            "bias": torch.zeros(c), "running_mean": torch.zeros(c),
            "running_var": torch.ones(c),
            "num_batches_tracked": torch.tensor(0)})
    want, mut = jmodel.apply(v, jnp.asarray(x, jdt), train=True,
                             mutable=["batch_stats"])
    got = port(nchw(x).to(tdt))
    assert got.dtype == tdt
    tol = FWD_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(nhwc(got.float()),
                               np.asarray(want, np.float32), **tol)
    if kind == "batch":
        s = mut["batch_stats"]["BatchNorm_0"]
        assert port.running_mean.dtype == torch.float32
        np.testing.assert_allclose(port.running_mean.numpy(), s["mean"],
                                   **STATS_TOL)
        np.testing.assert_allclose(port.running_var.numpy(), s["var"],
                                   **STATS_TOL)


@pytest.mark.parametrize("mode", ["vanilla", "lsgan", "wgangp"])
def test_gan_loss_matches_jax(rng, mode):
    pred = (3.0 * rng.standard_normal((2, 1, 6, 6))).astype(np.float32)
    for real in (True, False):
        want = float(JP.GANLoss(mode)(jnp.asarray(pred), real))
        got = float(PP.GANLoss(mode)(torch.from_numpy(pred), real))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), (mode, real)


def test_reference_state_dicts_load_natively(rng):
    """Reference-layout state dicts load into the port with no key left
    over or missing, and give the output of JAX's networks after JAX's
    ``port_*`` mapping: the U-Net from ``_unet_sd`` (an independent
    construction of the reference keys), the ResNet and the PatchGAN from the
    port's own keys filled with numpy values."""
    x = rng.random((2, 64, 64, 3)).astype(np.float32)
    for norm in ("batch", "instance"):
        sd = _unet_sd(rng, DOWNS, NGF, norm=norm)
        port = load(thin_g("port", "unet_256", norm),
                    {k: torch.from_numpy(v) for k, v in sd.items()}).eval()
        params, stats = TP.port_unet_generator(sd, DOWNS)
        v = {"params": params, "batch_stats": stats}
        want = jax.jit(thin_g("jax", "unet_256", norm).apply)(v, x)
        with torch.no_grad():
            np.testing.assert_allclose(nhwc(port(nchw(x))), np.asarray(want),
                                       **FWD_TOL)

    def filled(net):
        out = {}
        for k, t in net.state_dict().items():
            if k.endswith("num_batches_tracked"):
                continue
            a = (rng.uniform(0.5, 1.5, t.shape) if "running_var" in k
                 else 1.0 + 0.1 * rng.standard_normal(t.shape)
                 if t.ndim == 1 and k.endswith("weight")
                 else 0.05 * rng.standard_normal(t.shape))
            out[k] = a.astype(np.float32)
        return out

    x = x[:, :32, :32]
    port = thin_g("port", "resnet_9blocks", "batch").eval()
    sd = filled(port)
    load(port, {k: torch.from_numpy(v) for k, v in sd.items()})
    params, stats = TP.port_resnet_generator(sd, n_blocks=BLOCKS)
    want = jax.jit(thin_g("jax", "resnet_9blocks", "batch").apply)(
        {"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(port(nchw(x))), np.asarray(want),
                                   **FWD_TOL)

    xd = rng.random((2, 32, 32, 4)).astype(np.float32)
    port = PP.define_d("basic", NGF).eval()
    sd = filled(port)
    load(port, {k: torch.from_numpy(v) for k, v in sd.items()})
    params, stats = TP.port_patchgan_discriminator(sd)
    want = jax.jit(JP.define_d("basic", NGF).apply)(
        {"params": params, "batch_stats": stats}, xd)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(port(nchw(xd))), np.asarray(want),
                                   **FWD_TOL)


def test_dropout_keeps_half_and_doubles():
    """Dropout by its kept fraction and its 2x scale; a seeded generator
    repeats its mask; eval mode is the identity."""
    drop = PP.Dropout(0.5).train()
    x = torch.ones(200_000)
    drop.generator = torch.Generator().manual_seed(3)
    a = drop(x)
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    assert abs(float((a > 0).float().mean()) - 0.5) < 0.01
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(drop(x), a)
    assert torch.equal(drop.eval()(x), x)


# ------------------------------------------------------------ the G+D step

CONFIGS = {
    "resnet_basic": dict(net_g="resnet_9blocks", net_d="basic",
                         norm="batch", gan_mode="vanilla"),
    "unet_pixel": dict(net_g="unet_256", net_d="pixel", norm="instance",
                       gan_mode="lsgan"),
}


@pytest.fixture
def thin_defines(monkeypatch):
    """Both packages' ``define_g`` build the thin generators (JAX's fixes
    9 blocks and 8 downs; the test alone patches it)."""
    monkeypatch.setattr(JG, "define_g", lambda net, oc, ngf, norm, drop,
                        dtype=None: (JP.ResnetGenerator(
                            oc, ngf, BLOCKS, norm, drop, dtype)
                            if net == "resnet_9blocks" else JP.UnetGenerator(
                                oc, DOWNS, ngf, norm, drop, dtype)))
    monkeypatch.setattr(PG, "define_g", lambda net, oc, ngf, norm, drop,
                        dtype=None, inc=3: (PP.ResnetGenerator(
                            inc, oc, ngf, BLOCKS, norm, drop, dtype)
                            if net == "resnet_9blocks" else PP.UnetGenerator(
                                inc, oc, DOWNS, ngf, norm, drop, dtype)))


def pair(cfg: dict, size: int, bf16: bool = False):
    """(JAX Pix2Pix, port Pix2Pix) holding the same flax init."""
    kw = dict(image_size=size, ngf=NGF, ndf=NGF, use_dropout=False, **cfg)
    jm = JG.Pix2Pix(JG.Pix2PixConfig(**kw), jax.random.key(0))
    pm = PG.Pix2Pix(PG.Pix2PixConfig(bf16=bf16, **kw), device="cpu")
    load(pm.net_g, g_to_sd(cfg["net_g"], to_np(jm.g.params),
                           to_np(jm.g.batch_stats)))
    load(pm.net_d, PW.pix2pix_d_from_flax(cfg["net_d"], to_np(jm.d.params),
                                          to_np(jm.d.batch_stats)))
    return jm, pm


def gan_batch(rng, size: int, b: int = 2):
    a = rng.random((b, size, size, 3)).astype(np.float32)
    bb = rng.random((b, size, size, 1)).astype(np.float32)
    return ({"A": jnp.asarray(a), "B": jnp.asarray(bb)},
            {"A": nchw(a), "B": nchw(bb)})


def assert_side_matches(net, opt, state, to_sd, lr):
    """Parameters, running statistics and Adam moments of one net after a
    step (see the module docstring for the tolerances)."""
    want = to_sd(to_np(state.params), to_np(state.batch_stats))
    adam = state.opt_state[0]
    mu = to_sd(to_np(adam.mu), to_np(state.batch_stats))
    nu = to_sd(to_np(adam.nu), to_np(state.batch_stats))
    assert_stats(net, want)
    named = dict(net.named_parameters())
    assert set(named) <= set(want)
    net_max = max(np.abs(mu[k].numpy()).max() for k in named)
    for k, p in named.items():
        st = opt.state[p]
        assert int(st["step"]) == int(adam.count), k
        m_p, m_j = st["exp_avg"].numpy(), mu[k].numpy()
        v_p, v_j = st["exp_avg_sq"].numpy(), nu[k].numpy()
        if np.abs(m_j).max() <= 1e-6 * net_max:  # a norm's exact zero
            assert np.abs(m_p).max() <= 1e-6 * net_max, k
            noise = np.ones(m_j.shape, bool)
        else:
            for got, ref, tol in ((m_p, m_j, MOMENT_RTOL),
                                  (v_p, v_j, 2 * MOMENT_RTOL)):
                assert (np.linalg.norm(got - ref)
                        <= tol * np.linalg.norm(ref)), k
            noise = np.abs(m_j) <= 1e-5 * np.abs(m_j).max()
        got, ref = p.detach().numpy(), want[k].numpy()
        err = np.abs(got - ref)
        assert (err[~noise] <= 1e-4 * np.abs(ref[~noise])
                + 1e-4 * lr).all(), (k, err[~noise].max())
        assert (err[noise] <= 2 * lr * (1 + 1e-3)).all(), k


@pytest.mark.parametrize("name", ["resnet_basic", "unet_pixel"])
def test_step_matches_jax(rng, thin_defines, name):
    """One G+D step against JAX's: the six losses, both parameter sets,
    both running statistics and the Adam moments. D's statistics come out
    as JAX's, which drops those of the G pass; G's advance once (JAX
    replays its forward). After the ResNet's step, ``eval_losses`` at rtol
    1e-4 and ``generate`` at rtol 1e-3, absolute 1e-4 (the stepped
    parameters' own agreement carried through the net)."""
    size = 32 if name == "resnet_basic" else 64
    cfg = CONFIGS[name]
    jm, pm = pair(cfg, size)
    jb, pb = gan_batch(rng, size)
    want = jm.train_step(jb, jax.random.key(1))
    got = pm.train_step(pb, 1)
    assert set(got) == set(want) == set(PG.LOSS_KEYS)
    for k in want:
        assert float(got[k]) == pytest.approx(
            float(want[k]), rel=LOSS_TOL["rtol"], abs=LOSS_TOL["atol"]), k
    lr = pm.cfg.lr
    assert_side_matches(pm.net_d, pm.opt_d, jm.d, lambda p, s:
                        PW.pix2pix_d_from_flax(cfg["net_d"], p, s), lr)
    assert_side_matches(pm.net_g, pm.opt_g, jm.g, lambda p, s:
                        g_to_sd(cfg["net_g"], p, s), lr)
    if name == "resnet_basic":
        # eval mode from the stepped nets (which agree as held above)
        want, got = jm.eval_losses(jb), pm.eval_losses(pb)
        assert set(got) == set(want)
        for k in want:
            assert float(got[k]) == pytest.approx(float(want[k]),
                                                  rel=1e-4), k
        fake = pm.generate(pb["A"])
        assert fake.dtype == torch.float32 and fake.shape == (2, 1, 32, 32)
        np.testing.assert_allclose(nhwc(fake),
                                   np.asarray(jm.generate(jb["A"])),
                                   rtol=1e-3, atol=1e-4)


def test_decoder_only_steps_d_alone(rng):
    """The warm-up step: D's parameters, Adam state and statistics are
    bit for bit those of a full step from the same init (the D step does
    not depend on it), G's parameters are bit for bit unchanged with an
    empty Adam state, G's statistics are the full step's (one forward
    each), and the G losses are zeros. The CLI test holds the warm-up
    epoch's losses against JAX's."""
    cfg = PG.Pix2PixConfig(image_size=32, ngf=NGF, ndf=NGF, use_dropout=False)
    full = PG.Pix2Pix(cfg, seed=4, device="cpu")
    warm = PG.Pix2Pix(cfg, seed=4, device="cpu")
    g0 = {k: v.clone() for k, v in warm.net_g.state_dict().items()}
    _, b = gan_batch(rng, 32)
    lf, lw = full.train_step(b, 1), warm.train_step(b, 1, decoder_only=True)
    for k in ("D_fake", "D_real", "D_total"):
        assert torch.equal(lf[k], lw[k]), k
    assert all(float(lw[k]) == 0.0 for k in ("G_GAN", "G_L1", "G_total"))
    for a, b_ in ((full.net_d.state_dict(), warm.net_d.state_dict()),
                  (full.opt_d.state_dict()["state"],
                   warm.opt_d.state_dict()["state"])):
        for k in a:
            for x, y in (zip(a[k].values(), b_[k].values())
                         if isinstance(a[k], dict) else [(a[k], b_[k])]):
                assert torch.equal(x, y), k
    for k, v in warm.net_g.state_dict().items():
        if "running_" in k or "num_batches" in k:
            assert torch.equal(v, full.net_g.state_dict()[k]), k
            assert "num_batches" in k or not torch.equal(v, g0[k]), k
        else:
            assert torch.equal(v, g0[k]), k
    assert not warm.opt_g.state


def test_single_forward_semantics(rng):
    """With dropout on: G's running statistics after a step are those of
    ONE train-mode forward of the initial G with the step's dropout seed
    (JAX's ``test_pix2pix_single_forward_semantics``), G's GAN loss is the
    UPDATED D's on that same forward, and D's statistics are those of the
    D step alone (its fake then its real pass)."""
    cfg = PG.Pix2PixConfig(image_size=32, ngf=NGF, ndf=NGF, use_dropout=True)
    pm = PG.Pix2Pix(cfg, seed=3, device="cpu")
    _, b = gan_batch(rng, 32)
    g0, d0 = copy.deepcopy(pm.net_g), copy.deepcopy(pm.net_d)
    losses = pm.train_step(b, seed=7)

    g0.train()
    PP.set_dropout_generator(g0, torch.Generator().manual_seed(7))
    with torch.no_grad():
        fake = g0(b["A"])
    for k, v in port_stats(g0).items():
        np.testing.assert_allclose(port_stats(pm.net_g)[k], v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    d0.train()
    with torch.no_grad():
        d0(torch.cat([b["A"], fake], 1))
        d0(torch.cat([b["A"], b["B"]], 1))
        d1 = copy.deepcopy(pm.net_d).train()
        pred = d1(torch.cat([b["A"], fake], 1))
    for k, v in port_stats(d0).items():
        np.testing.assert_allclose(port_stats(pm.net_d)[k], v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert float(losses["G_GAN"]) == pytest.approx(
        float(pm.criterion(pred, True)), rel=1e-6)
    l1 = float(torch.mean(torch.abs(fake - b["B"]))) * cfg.lambda_l1
    assert float(losses["G_L1"]) == pytest.approx(l1, rel=1e-6)


def test_bf16_tracks_float32(rng):
    """``bf16``: the same init, float32 parameters, Adam state and running
    statistics, losses within JAX's bf16 bounds of float32 (rel 0.1, abs
    0.05), float32 samples within a mean of 0.05 of float32's
    (``tests/test_train_gan_vae.py:114-146``)."""
    kw = dict(image_size=32, ngf=NGF, ndf=NGF)
    m32 = PG.Pix2Pix(PG.Pix2PixConfig(**kw), seed=0, device="cpu")
    mbf = PG.Pix2Pix(PG.Pix2PixConfig(bf16=True, **kw), seed=0, device="cpu")
    for a, b in zip(m32.net_g.state_dict().values(),
                    mbf.net_g.state_dict().values()):
        assert torch.equal(a, b)
    _, b = gan_batch(rng, 32)
    l32, lbf = m32.train_step(b, 1), mbf.train_step(b, 1)
    for k in ("G_GAN", "G_L1", "D_real", "D_fake"):
        assert lbf[k].dtype == torch.float32 and np.isfinite(float(lbf[k]))
        assert float(lbf[k]) == pytest.approx(float(l32[k]), rel=0.1,
                                              abs=0.05), k
    for net, opt in ((mbf.net_g, mbf.opt_g), (mbf.net_d, mbf.opt_d)):
        for t in net.state_dict().values():
            assert not t.is_floating_point() or t.dtype == torch.float32
        for st in opt.state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == \
                torch.float32
    out32, outbf = m32.generate(b["A"]), mbf.generate(b["A"])
    assert outbf.dtype == torch.float32
    assert float((out32 - outbf).abs().mean()) < 0.05


@pytest.mark.cuda
def test_cuda_step_matches_cpu(rng):
    """On the card: a float32 step (TF32 off) from the same init as on the
    CPU, losses at rtol 1e-4 (``chip_smoke.py``'s ``pix2pix`` phase holds
    the full-width step against float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run by chip_smoke.py)")
    from art_sbir_tpu_torch.core.device import ieee_f32

    ieee_f32()
    cfg = PG.Pix2PixConfig(image_size=32, ngf=NGF, ndf=NGF, use_dropout=False)
    _, b = gan_batch(rng, 32)
    cpu = PG.Pix2Pix(cfg, seed=0, device="cpu").train_step(b, 1)
    card = PG.Pix2Pix(cfg, seed=0, device="cuda").train_step(b, 1)
    for k in cpu:
        assert float(card[k]) == pytest.approx(float(cpu[k]), rel=1e-4), k
