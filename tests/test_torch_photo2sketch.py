"""The port's Photo2Sketch VAE, GMM losses and trainer against the JAX
package's, on the CPU, at thin shapes (``z_size`` 8, ``dec_rnn_size`` 16,
3 mixtures, 10 stroke rows, 64 px photos; JAX
``tests/test_train_gan_vae.py:90-112``).

Weights come from JAX's own init (``VAETrainer``'s), carried into the port
by ``models/port_weights.py::photo2sketch_from_flax``; inputs are
numpy-seeded; the reparameterization noise is JAX's own
``jax.random.normal(key, mu.shape)``, fed to the port. The port is NCHW
and JAX NHWC; photos are transposed on the way in.

* Forwards (VGG's features, the encoder's mu and log var, the
  teacher-forced mixture) at rtol 1e-4 with an absolute 1e-6: the two
  packages' float32 convolutions and reductions sum in other orders.
* The GMM loss, masked and unmasked, at rtol 1e-5, and JAX's far-tail
  case (the NLL exactly ``-log 1e-6``).
* The greedy decode over 11 steps: the pen states equal, the
  coordinates at the forwards' tolerance (the smallest argmax margin is
  printed), the attention at an absolute 1e-5.
* One train step: the losses at rtol 1e-5, every gradient norm-wise at
  rtol 1e-4 (a symmetry's zero, conv_att's bias under the softmax, as
  rounding noise under 1e-6 of the largest on both sides), the global norm and the clip factor at rtol 1e-5; then Adam
  from JAX's gradients (fed to both) at rtol 1e-6, atol 1e-8 (the LSTM's
  at one float32 spacing at 2k: JAX stores them shifted by k).
* The schedules at steps 0, 1 and 10^5 at rtol 1e-6 (both in float32).
* bf16: JAX's bounds of float32 (rel 0.05, abs 0.02), float32 parameters
  and Adam state.
* A reference-layout state dict loads natively and gives JAX's output
  after JAX's ``port_photo2sketch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from art_sbir_tpu.models import torch_port as TP
from art_sbir_tpu.models.photo2sketch import Photo2Sketch as JaxP2S
from art_sbir_tpu.models.vgg import VGGFeatures as JaxVGG
from art_sbir_tpu.ops import gmm as JG
from art_sbir_tpu.train import vae as JV
from art_sbir_tpu_torch.models.photo2sketch import Photo2Sketch
from art_sbir_tpu_torch.models.port_weights import photo2sketch_from_flax
from art_sbir_tpu_torch.models.vgg import VGGFeatures
from art_sbir_tpu_torch.ops import gmm as PG
from art_sbir_tpu_torch.train import vae as PV
from tests.test_torch_port_photo2sketch import _fake_p2s_state_dict
from tests.torch_threads import two_torch_threads  # noqa: F401

FWD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_RTOL = 1e-4
ADAM_TOL = dict(rtol=1e-6, atol=1e-8)
Z, HID, M, T, S, B = 8, 16, 3, 10, 64, 2
CFG = dict(z_size=Z, dec_rnn_size=HID, num_mixture=M, max_seq_len=T,
           image_size=S)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def jax_trainer():
    return JV.VAETrainer(JV.VAEConfig(**CFG), jax.random.key(0))


@pytest.fixture(scope="module")
def params(jax_trainer):
    return jax.tree_util.tree_map(np.asarray, jax_trainer.state.params)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    return {"photo": rng.standard_normal((B, S, S, 3)).astype(np.float32),
            "sketch_vector": rng.standard_normal((B, T, 5)).astype(
                np.float32)}


@pytest.fixture(scope="module")
def eps():
    return np.asarray(jax.random.normal(jax.random.key(1), (B, Z)))


def port_model(params, **kw) -> Photo2Sketch:
    model = Photo2Sketch(Z, HID, M, **kw)
    model.load_state_dict(photo2sketch_from_flax(params))
    return model


def port_grads(grads) -> dict:
    """JAX gradients in the port's layout: the LSTM's are transposed, not
    shifted by k (the shift is the parameters', not the gradients')."""
    out = photo2sketch_from_flax(grads)
    lstm = grads["Sketch_Decoder"]["lstm"]
    for side in ("ih", "hh"):
        out[f"Sketch_Decoder.lstm.weight_{side}_l0"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(lstm[f"{side}_kernel"]).T))
        out[f"Sketch_Decoder.lstm.bias_{side}_l0"] = torch.from_numpy(
            np.asarray(lstm[f"{side}_bias"]))
    return out


def test_vgg_features_match(params, batch):
    feat_j = jax.jit(JaxVGG().apply)(
        {"params": params["Image_Encoder"]["feature"]}, batch["photo"])
    vgg = VGGFeatures()
    sd = {k[len("Image_Encoder.feature."):]: v
          for k, v in photo2sketch_from_flax(params).items()
          if k.startswith("Image_Encoder.feature.")}
    vgg.load_state_dict(sd)
    with torch.no_grad():
        got = vgg(nchw(batch["photo"])).permute(0, 2, 3, 1).numpy()
    assert got.shape == (B, S // 32, S // 32, 512)
    np.testing.assert_allclose(got, np.asarray(feat_j), **FWD_TOL)


def test_forward_matches(params, batch, eps):
    model = JaxP2S(**{k: v for k, v in CFG.items() if k != "image_size"})
    # JAX draws its noise from the key; the port takes the same draw
    gmm_j, mu_j, lv_j = jax.jit(model.apply)(
        {"params": params}, batch["photo"], batch["sketch_vector"],
        jax.random.key(1))
    with torch.no_grad():
        gmm_p, mu_p, lv_p = port_model(params)(
            nchw(batch["photo"]), torch.from_numpy(batch["sketch_vector"]),
            torch.from_numpy(eps))
    np.testing.assert_allclose(mu_p.numpy(), np.asarray(mu_j), **FWD_TOL)
    np.testing.assert_allclose(lv_p.numpy(), np.asarray(lv_j), **FWD_TOL)
    for name, got, want in zip(gmm_j._fields, gmm_p, gmm_j):
        assert got.shape == (B, T + 1) + want.shape[2:], name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL,
                                   err_msg=name)


def test_noise_from_a_generator_is_seeded(params, batch):
    model = port_model(params)
    args = (nchw(batch["photo"]), torch.from_numpy(batch["sketch_vector"]))
    with torch.no_grad():
        a = model(*args, torch.Generator().manual_seed(3))[0].mu1
        b = model(*args, torch.Generator().manual_seed(3))[0].mu1
        c = model(*args, torch.Generator().manual_seed(4))[0].mu1
    assert torch.equal(a, b) and not torch.equal(a, c)


def _gmm_case(rng, t=7, m=5):
    y = rng.standard_normal((3, t, 6 * m + 3)).astype(np.float32)
    target = np.zeros((3, t, 5), np.float32)
    target[..., :2] = rng.standard_normal((3, t, 2))
    states = rng.integers(0, 3, (3, t))
    target[np.arange(3)[:, None], np.arange(t)[None], 2 + states] = 1.0
    return y, target, m


@pytest.mark.parametrize("use_mask", [True, False])
def test_gmm_loss_matches(use_mask):
    y, target, m = _gmm_case(np.random.default_rng(11))
    want = JG.sketch_reconstruction_loss(
        JG.split_decoder_output(jnp.asarray(y), m), jnp.asarray(target),
        use_mask)
    got = PG.sketch_reconstruction_loss(
        PG.split_decoder_output(torch.from_numpy(y), m),
        torch.from_numpy(target), use_mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), **LOSS_TOL)


def test_gmm_far_tail_and_kl_floor():
    """JAX ``tests/test_ops_gmm.py:76-90``: far from every mean the NLL is
    exactly -log(1e-6), finite; the KL of N(0, 1) is floored."""
    rng = np.random.default_rng(0)
    y = rng.standard_normal((2, 3, 6 * 20 + 3)).astype(np.float32)
    target = np.zeros((2, 3, 5), np.float32)
    target[..., 0] = 1e4
    target[..., 2] = 1.0
    total, nll, _ = PG.sketch_reconstruction_loss(
        PG.split_decoder_output(torch.from_numpy(y), 20),
        torch.from_numpy(target), False)
    _, nll_j, _ = JG.sketch_reconstruction_loss(
        JG.split_decoder_output(jnp.asarray(y), 20), jnp.asarray(target),
        False)
    assert np.isfinite(float(total))
    np.testing.assert_allclose(float(nll), -np.log(1e-6), rtol=1e-6)
    np.testing.assert_allclose(float(nll), float(nll_j), rtol=1e-6)
    mean, log_var = np.zeros((4, 8), np.float32), np.zeros((4, 8), np.float32)
    kl = PG.kl_divergence_to_standard_normal(
        torch.from_numpy(mean), torch.from_numpy(log_var), 0.2)
    assert float(kl) == pytest.approx(0.2)
    mean[0] = 3.0
    got = PG.kl_divergence_to_standard_normal(
        torch.from_numpy(mean), torch.from_numpy(log_var), 0.2)
    want = JG.kl_divergence_to_standard_normal(mean, log_var, 0.2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_generate_matches(jax_trainer, params, batch):
    steps = T + 1
    strokes_j, alpha_j = jax_trainer.generate(
        jnp.asarray(batch["photo"]), jax.random.key(3), num_steps=steps)
    model = port_model(params)
    with torch.no_grad():
        strokes_p, alpha_p = model.generate(nchw(batch["photo"]), steps)
        # the argmax margins along JAX's own sequence
        feat, mu, _ = model.Image_Encoder(nchw(batch["photo"]))
        dec = model.Sketch_Decoder
        h, c = dec._init_state(mu)
        x_em, tokens = dec.attention_cell.embed(feat)
        stroke, margin = dec._start(B, mu), np.inf
        for s in range(steps):
            h, c, _ = dec._step(h, c, stroke, x_em, tokens)
            p = PG.split_decoder_output(dec.fc_params(h), M)
            for logits in (p.log_pi, p.pen_logits):
                top2 = torch.topk(logits, 2, dim=-1).values
                margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
            stroke = torch.from_numpy(np.asarray(strokes_j[:, s]))
    print(f"smallest argmax margin over {steps} steps: {margin:.3g}")
    assert strokes_p.shape == (B, steps, 5)
    assert alpha_p.shape == (B, steps, (S // 32) ** 2)
    pen = strokes_p[..., 2:].numpy()
    np.testing.assert_array_equal(pen, np.asarray(strokes_j[..., 2:]))
    np.testing.assert_allclose(strokes_p[..., :2].numpy(),
                               np.asarray(strokes_j[..., :2]), **FWD_TOL)
    np.testing.assert_allclose(alpha_p.numpy(), np.asarray(alpha_j),
                               rtol=0, atol=1e-5)


def test_train_step_matches(jax_trainer, params, batch, eps):
    """Losses, gradients, the clip and Adam against JAX's step (the JAX
    trainer's step count is 0 here: the fixture never stepped it)."""
    jt = jax_trainer
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jt.state
    assert int(state.step) == 0
    (_, losses_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jt._losses(p, jbatch, jax.random.key(1), state.step),
        has_aux=True))(state.params)
    grads_j = jax.tree_util.tree_map(np.asarray, grads_j)

    trainer = PV.VAETrainer(PV.VAEConfig(**CFG), device="cpu")
    trainer.model.load_state_dict(photo2sketch_from_flax(params))
    port_batch = {"photo": nchw(batch["photo"]),
                  "sketch_vector": torch.from_numpy(batch["sketch_vector"])}
    losses_p = trainer.compute_gradients(port_batch, torch.from_numpy(eps))
    for k in PV.LOSS_KEYS:
        np.testing.assert_allclose(float(losses_p[k]), float(losses_j[k]),
                                   **LOSS_TOL, err_msg=k)
    want = port_grads(grads_j)
    named = dict(trainer.model.named_parameters())
    assert set(named) == set(want)
    # conv_att's bias moves every logit alike, which the softmax takes
    # back: its gradient is 0 but for rounding, on both sides
    scale = max(float(g.norm()) for g in want.values())
    for k, p in named.items():
        if float(want[k].norm()) <= 1e-6 * scale:
            assert float(p.grad.norm()) <= 1e-6 * scale, k
            continue
        err = float((p.grad - want[k]).norm() / want[k].norm())
        assert err <= GRAD_RTOL, (k, err)

    # Adam (after the clip) from JAX's gradients, fed to both sides
    for k, p in named.items():
        p.grad = want[k].clone()
    trainer.apply_gradients()
    norm_j = float(optax.global_norm(grads_j))
    np.testing.assert_allclose(float(trainer.grad_norm), norm_j, rtol=1e-5)
    factor = min(1.0, PV.VAEConfig().grad_clip / norm_j)
    print(f"global norm {norm_j:.4g}, clip factor {factor:.4g}")
    new_j = photo2sketch_from_flax(jax.jit(
        lambda g: optax.apply_updates(state.params, state.tx.update(
            g, state.opt_state, state.params)[0]))(grads_j))
    assert trainer.step == 1
    # JAX stores the LSTM's weights shifted by k = 1 / sqrt(H), in [0, 2k]:
    # taking k off again rounds to a float32 spacing at 2k
    lstm_atol = float(np.spacing(np.float32(2.0 / np.sqrt(HID))))
    for k, p in named.items():
        tol = dict(ADAM_TOL, atol=lstm_atol) if ".lstm." in k else ADAM_TOL
        np.testing.assert_allclose(p.detach().numpy(), new_j[k].numpy(),
                                   **tol, err_msg=k)


def test_clip_follows_optax():
    """Below the norm the gradients stay bit for bit; above it they become
    g / norm * max_norm (torch's clip_grad_norm_ divides by norm + 1e-6)."""
    g = [torch.tensor([0.3, -0.4]), torch.tensor([0.0])]
    before = [x.clone() for x in g]
    norm = PV.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(0.5)
    assert all(torch.equal(a, b) for a, b in zip(g, before))
    g = [torch.tensor([3.0, -4.0])]
    PV.clip_by_global_norm(g, 1.0)
    want = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray([3.0, -4.0])], None)[0][0]
    np.testing.assert_array_equal(g[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("step", [0, 1, 100_000])
def test_schedules_match(step):
    cfg_p, cfg_j = PV.VAEConfig(), JV.VAEConfig()
    np.testing.assert_allclose(
        PV.kl_weight_at(cfg_p, step),
        float(JV.kl_weight_at(cfg_j, jnp.int32(step))), rtol=1e-6)
    np.testing.assert_allclose(
        PV.lr_at(cfg_p, step), float(JV._lr_schedule(cfg_j)(jnp.int32(step))),
        rtol=1e-6)
    if step == 0:
        assert PV.kl_weight_at(cfg_p, 0) == pytest.approx(0.01)
        assert PV.lr_at(cfg_p, 0) == pytest.approx(1e-4)


def test_bf16_encoder_tracks_f32(params, batch, eps):
    """JAX ``tests/test_train_gan_vae.py:149-175``: the same float32
    weights, a train step's losses within rel 0.05, abs 0.02, and float32
    parameters and Adam state."""
    port_batch = {"photo": nchw(batch["photo"]),
                  "sketch_vector": torch.from_numpy(batch["sketch_vector"])}
    losses, trainers = {}, {}
    for bf16 in (False, True):
        t = PV.VAETrainer(PV.VAEConfig(**CFG, bf16_encoder=bf16),
                          device="cpu")
        t.model.load_state_dict(photo2sketch_from_flax(params))
        losses[bf16] = t.train_step(port_batch, torch.from_numpy(eps))
        trainers[bf16] = t
    for k in PV.LOSS_KEYS:
        got, want = float(losses[True][k]), float(losses[False][k])
        assert np.isfinite(got)
        assert got == pytest.approx(want, rel=0.05, abs=0.02), k
    t = trainers[True]
    assert all(p.dtype == torch.float32 for p in t.model.parameters())
    assert all(v.dtype == torch.float32 for s in t.optimizer.state.values()
               for v in s.values() if v.is_floating_point() and v.dim())
    with torch.no_grad():
        feat = t.model.Image_Encoder.feature(port_batch["photo"])
    assert feat.dtype == torch.bfloat16


def test_reference_state_dict_loads_natively():
    """A reference checkpoint's keys load with ``load_state_dict`` as they
    are, and the port's forward gives JAX's after ``port_photo2sketch``."""
    rng = np.random.default_rng(7)
    sd = _fake_p2s_state_dict(rng, hidden=HID, z=Z, m=M)
    model = Photo2Sketch(Z, HID, M)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jm = JaxP2S(z_size=Z, dec_rnn_size=HID, num_mixture=M, max_seq_len=T)
    img = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    sketch = rng.standard_normal((B, T, 5)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), img, sketch,
                            jax.random.key(1))
    init = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes["params"])
    merged = TP.merge_into(init, TP.port_photo2sketch(sd, hidden=HID))
    gmm_j, mu_j, _ = jax.jit(jm.apply)({"params": merged}, img, sketch,
                                       jax.random.key(2))
    noise = np.asarray(jax.random.normal(jax.random.key(2), (B, Z)))
    with torch.no_grad():
        gmm_p, mu_p, _ = model(nchw(img), torch.from_numpy(sketch),
                               torch.from_numpy(noise))
    np.testing.assert_allclose(mu_p.numpy(), np.asarray(mu_j), **FWD_TOL)
    for name, got, want in zip(gmm_j._fields, gmm_p, gmm_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
