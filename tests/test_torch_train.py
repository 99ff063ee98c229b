"""The port's training slice against the JAX package's, on the CPU.

One synthesized reference-layout state dict (``tests/test_torch_resnet.py``)
goes into flax and, carried back by ``models/port_weights.py``, into the
port; the same inputs, made from a numpy seed, go through both.

* ``BatchNorm2d`` in train mode against flax ``nn.BatchNorm``: outputs and
  running statistics at rtol 1e-5 (float32 and bf16). torch's own update
  takes the unbiased variance, n / (n - 1) times flax's.
* The encoder in train mode, ``forward3`` (three embeddings and the
  sequential running statistics), the gradients of the loss with 0, 1
  and 2 heads (per tensor ||g_port - g_jax|| <= 1e-4 ||g_jax||; where
  JAX's is below 1e-6 of the largest, a symmetry's exact zero in rounding
  noise, the port's must be too: the key bias always, as the softmax
  ignores a shift of a head's logits, and the value and output biases
  under the euclidean loss without heads, which a shift of every
  embedding leaves alone), one Adam
  update from the same gradients (rtol 1e-6), the eval step and
  ``TripletTrainer.run`` on fed batches: float32, the encoder's parity
  bound rtol 1e-4 with an absolute 1e-4 for embeddings, rtol 1e-5 with an
  absolute 1e-5 for losses (a difference of distances keeps their
  absolute error) and with an absolute 1e-6 for running statistics.
* The loss variants and ``TripletLossConfig.for_dataset``'s table.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from art_sbir_tpu.core.metrics import LossTracker as JaxLossTracker
from art_sbir_tpu.train import losses as JL
from art_sbir_tpu.train import triplet as JT
from art_sbir_tpu_torch.core.metrics import LossTracker
from art_sbir_tpu_torch.models import port_weights as PW
from art_sbir_tpu_torch.models import resnet as R
from art_sbir_tpu_torch.train import losses as PL
from art_sbir_tpu_torch.train import triplet as PT
from tests.test_torch_resnet import LAYERS, RES, _flax, _sd
from tests.torch_threads import two_torch_threads  # noqa: F401


B = 3
EMBED_TOL = dict(rtol=1e-4, atol=1e-4)
# running statistics are O(0.1-1); a mean near 0 keeps the absolute error
# of the float32 chain that led to it (about 1e-7)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
# a margin loss is a difference of distances: it keeps their absolute
# float32 error (about 1e-6 of distances of a few units)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


def _stats_of(model) -> dict:
    return {k: v.numpy() for k, v in model.state_dict().items()
            if "running_" in k}


def _to_sd(tree, stats, heads):
    convert = (PW.modified_resnet_with_classification_from_flax if heads
               else PW.modified_resnet_from_flax)
    return convert(tree, stats, LAYERS)


def _pair(heads=0, seed=0):
    """(flax model, params, stats, port model in train mode), float32."""
    model, params, stats = _flax(_sd(np.random.default_rng(seed), heads),
                                 heads)
    port = R.ModifiedResNetWithClassification(
        num_classes=5, num_classes2=3 if heads == 2 else 0,
        compute_dtype=torch.float32, layers=LAYERS, output_dim=32, heads=4,
        input_resolution=RES, width=8) if heads else R.ModifiedResNet(
        compute_dtype=torch.float32, layers=LAYERS, output_dim=32, heads=4,
        input_resolution=RES, width=8)
    port.load_state_dict(_to_sd(params, stats, heads))
    return model, params, stats, port.train()


def _batch(seed=1, heads=0):
    rng = np.random.default_rng(seed)
    b = {k: rng.standard_normal((B, RES, RES, 3)).astype(np.float32)
         for k in ("sketch", "positive", "negative")}
    if heads:
        b["label"] = rng.integers(0, 5, B).astype(np.int32)
    if heads == 2:
        b["label2"] = rng.integers(0, 3, B).astype(np.int32)
    return b


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _cfg(heads, loss_type="euclidean"):
    w = {0: (0.0, 0.0), 1: (0.5, 0.0), 2: (0.25, 0.5)}[heads]
    return dict(margin=0.2, loss_type=loss_type, classification_weight=w[0],
                classification_weight2=w[1], num_heads=heads)


def _assert_stats(port, params, new_stats, heads):
    want = _to_sd(params, new_stats, heads)
    got = _stats_of(port)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k].numpy(), **STATS_TOL,
                                   err_msg=k)


# ------------------------------------------------------------ BatchNorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    """Outputs and running statistics after two train-mode calls; the
    running variance takes the biased batch variance, as flax's does."""
    rng = np.random.default_rng(3)
    c = 6
    xs = [(2.0 * rng.standard_normal((2, 3, 3, c)) + 0.5).astype(np.float32)
          for _ in range(2)]
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var0 = (1.0 + 0.1 * rng.random(c)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jdt)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    port = R.BatchNorm2d(c).train()
    port.load_state_dict({"weight": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0),
                          "num_batches_tracked": torch.tensor(0)})
    for x in xs:
        want, muts = bn.apply(variables, jnp.asarray(x, jdt),
                              mutable=["batch_stats"])
        variables = {**variables, **muts}
        got = port(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2))
        assert got.dtype == tdt
        np.testing.assert_allclose(
            got.detach().float().permute(0, 2, 3, 1).numpy(),
            np.asarray(want, np.float32), rtol=1e-5, atol=1e-6)
        stats = variables["batch_stats"]
        np.testing.assert_allclose(port.running_mean.numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-5)
        np.testing.assert_allclose(port.running_var.numpy(),
                                   np.asarray(stats["var"]), rtol=1e-5)


# ------------------------------------------------------- encoder, forward3


def test_encoder_train_mode_matches_flax():
    model, params, stats, port = _pair()
    x = _batch()["sketch"]
    want, muts = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **EMBED_TOL)
    _assert_stats(port, params, muts["batch_stats"], 0)


@pytest.mark.parametrize("heads", [0, 1])
def test_forward3_matches_jax(heads):
    """Three embeddings (each modality normalized by its own batch) and the
    running statistics of three sequential updates."""
    model, params, stats, port = _pair(heads)
    batch = _batch(heads=heads)
    split, new_stats = jax.jit(lambda p, s, b: JT._forward3(
        model.apply, p, s, b, train=True))(params, stats, _jax_batch(batch))
    got = PT.forward3(port, _port_batch(batch))
    for w, g in zip(split, got):
        if not heads:
            w, g = (w,), (g,)
        for wi, gi in zip(w, g):
            np.testing.assert_allclose(gi.detach().numpy(), np.asarray(wi),
                                       **EMBED_TOL)
    _assert_stats(port, params, new_stats, heads)


# ------------------------------------------------------- gradients, Adam


def _jax_grads(model, params, stats, batch, cfg):
    def loss_fn(p):
        (s, po, n), new_stats = JT._forward3(model.apply, p, stats, batch,
                                             train=True)
        out = JL.triplet_loss_with_heads(cfg, s, po, n, batch.get("label"),
                                         batch.get("label2"))
        return out["loss"], out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return out, grads


@pytest.mark.parametrize("heads,loss_type", [(0, "euclidean"), (1, "cosine"),
                                             (2, "euclidean")])
def test_loss_gradients_match_jax(heads, loss_type):
    model, params, stats, port = _pair(heads)
    batch = _batch(heads=heads)
    cfg = _cfg(heads, loss_type)
    want, grads = _jax_grads(model, params, stats, _jax_batch(batch),
                             JL.TripletLossConfig(**cfg))
    s, p, n = PT.forward3(port, _port_batch(batch))
    got = PL.triplet_loss_with_heads(
        PL.TripletLossConfig(**cfg), s, p, n,
        *[torch.from_numpy(batch[k]) if k in batch else None
          for k in ("label", "label2")])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **LOSS_TOL,
                                   err_msg=k)
    got["loss"].backward()
    want_g = _to_sd(grads, stats, heads)
    scale = max(np.linalg.norm(w.numpy()) for w in want_g.values())
    n_checked = 0
    for name, param in port.named_parameters():
        g, w = param.grad.numpy(), want_g[name].numpy()
        if np.linalg.norm(w) < 1e-6 * scale:
            # an exact zero in both sides' rounding noise
            assert np.linalg.norm(g) < 1e-6 * scale, name
        else:
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), name
        n_checked += 1
    assert n_checked == len(list(port.parameters()))


def test_adam_update_matches_torch_adam_chain():
    """One step from the same parameters and gradients: the port's Adam
    (weight decay added to the gradient) against the JAX package's
    ``torch_adam`` optax chain, rtol 1e-6. The chain's bias correction
    1 - 0.999 is taken in float32, 1.3e-5 off the double torch takes, so
    an update (about lr) may differ by lr * 1e-5: that is the absolute
    tolerance."""
    model, params, stats, port = _pair(1)
    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    tx = JT.torch_adam(1e-3, weight_decay=2e-3)
    new_params = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, params)
    want = _to_sd(new_params, stats, 1)
    opt = PT.torch_adam(port.parameters(), 1e-3, weight_decay=2e-3)
    g_sd = _to_sd(grads, stats, 1)
    for name, param in port.named_parameters():
        param.grad = g_sd[name].clone()
    opt.step()
    for name, param in port.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-3 * 1e-5,
                                   err_msg=name)


def test_adam_parity_recipe():
    """``tests/test_train_triplet.py::test_torch_adam_parity``'s toy
    problem, five steps, the port's optimizer against JAX's chain at that
    test's tolerance."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(8).astype(np.float32)
    target = rng.standard_normal(8).astype(np.float32)
    wt = torch.tensor(w0.copy(), requires_grad=True)
    opt = PT.torch_adam([wt], 0.1, weight_decay=0.01)
    for _ in range(5):
        opt.zero_grad()
        ((wt - torch.from_numpy(target)) ** 2).sum().backward()
        opt.step()
    tx = JT.torch_adam(0.1, weight_decay=0.01)
    wj = jnp.array(w0)
    st = tx.init(wj)
    grad_fn = jax.grad(lambda w: jnp.sum((w - jnp.array(target)) ** 2))
    for _ in range(5):
        upd, st = tx.update(grad_fn(wj), st, wj)
        wj = wj + upd
    np.testing.assert_allclose(np.asarray(wj), wt.detach().numpy(),
                               rtol=1e-3, atol=2e-4)


# ------------------------------------------------ eval step and trainer


def _jax_state(model, params, stats, lr):
    tx = JT.torch_adam(lr, weight_decay=2e-3)
    return JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=stats, opt_state=tx.init(params),
                         apply_fn=model.apply, tx=tx)


def test_eval_step_matches_jax():
    model, params, stats, port = _pair(1)
    batch = _batch(heads=1)
    cfg = _cfg(1)
    want = JT.make_eval_step(JL.TripletLossConfig(**cfg))(
        _jax_state(model, params, stats, 1e-3), _jax_batch(batch))
    state = PT.create_train_state(port, 1e-3)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = PT.make_eval_step(PL.TripletLossConfig(**cfg))(state,
                                                         _port_batch(batch))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **LOSS_TOL,
                                   err_msg=k)
    assert not port.training
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k  # the state does not move


def test_trainer_run_matches_jax():
    """Two epochs of two fed batches each, a test batch: the training
    dict's keys, the per-epoch losses and the step count."""
    model, params, stats, port = _pair(1)
    cfg = _cfg(1)
    train = [_batch(seed=10 + i, heads=1) for i in range(2)]
    test = [_batch(seed=20, heads=1)]
    _, want = JT.TripletTrainer(
        JL.TripletLossConfig(**cfg), batch_size=B, epochs=2).run(
        _jax_state(model, params, stats, 1e-5),
        lambda: iter([_jax_batch(b) for b in train]),
        lambda: iter([_jax_batch(b) for b in test]), log=lambda s: None)
    state = PT.create_train_state(port, 1e-5)
    state, got = PT.TripletTrainer(
        PL.TripletLossConfig(**cfg), batch_size=B, epochs=2).run(
        state, lambda: iter([_port_batch(b) for b in train]),
        lambda: iter([_port_batch(b) for b in test]), log=lambda s: None)
    assert set(got) == set(want)
    assert got["steps"] == want["steps"] == 4 == state.step
    assert got["mean_step_time"] > 0
    for k in ("train_losses", "test_losses"):
        np.testing.assert_allclose(got[k], want[k], **LOSS_TOL, err_msg=k)
    for k in ("iteration_loss_frequency", "iteration_test_size",
              "itrain_losses", "itest_losses"):
        assert got[k] == want[k], k


# ----------------------------------------------------------------- losses


@pytest.mark.parametrize("heads", [0, 1, 2])
@pytest.mark.parametrize("loss_type", ["euclidean", "cosine"])
def test_loss_variants_match_jax(heads, loss_type):
    rng = np.random.default_rng(7)
    emb = [rng.standard_normal((5, 16)).astype(np.float32) for _ in range(3)]
    logits = [[rng.standard_normal((5, n)).astype(np.float32)
               for n in (4, 3)[:heads]] for _ in range(3)]
    labels = rng.integers(0, 4, 5).astype(np.int32)
    labels2 = rng.integers(0, 3, 5).astype(np.int32)
    outs = [e if not heads else (e, *lg) for e, lg in zip(emb, logits)]
    cfg = _cfg(heads, loss_type)
    conv = lambda f, o: o if isinstance(o, np.ndarray) else tuple(  # noqa: E731
        f(a) for a in o)
    want = JL.triplet_loss_with_heads(
        JL.TripletLossConfig(**cfg),
        *[jnp.asarray(o) if not heads else conv(jnp.asarray, o)
          for o in outs], jnp.asarray(labels), jnp.asarray(labels2))
    got = PL.triplet_loss_with_heads(
        PL.TripletLossConfig(**cfg),
        *[torch.from_numpy(o) if not heads else conv(torch.from_numpy, o)
          for o in outs], torch.from_numpy(labels), torch.from_numpy(labels2))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **LOSS_TOL,
                                   err_msg=k)


def test_for_dataset_table_matches_jax():
    names = ["SketchyDatasetV1", "SketchyDatasetV2", "KaggleDatasetV2",
             "AugmentedKaggleDatasetV2", "MixedDatasetV2", "Unknown"]
    for name in names:
        for loss_type in ("euclidean", "cosine"):
            for with_cls in (False, True):
                want = JL.TripletLossConfig.for_dataset(name, loss_type,
                                                        with_cls, 0.3)
                got = PL.TripletLossConfig.for_dataset(name, loss_type,
                                                       with_cls, 0.3)
                assert (got.margin, got.loss_type, got.classification_weight,
                        got.classification_weight2, got.num_heads) == (
                    want.margin, want.loss_type, want.classification_weight,
                    want.classification_weight2, want.num_heads), (
                    name, loss_type, with_cls)
    with pytest.raises(ValueError, match="loss type not correct"):
        PL.triplet_margin_loss(*[torch.zeros(2, 3)] * 3, loss_type="l1")


def test_loss_tracker_matches_jax():
    """'add' keeps device scalars on the device; 'append' reads them."""
    keys = ["loss", "triplet"]
    steps = [{"loss": 1.5, "triplet": 0.5}, {"loss": 0.25, "triplet": 2.0}]
    want, got = JaxLossTracker(keys), LossTracker(keys)
    for st in steps:
        want.add({k: jnp.float32(v) for k, v in st.items()}, size=2)
        got.add({k: torch.tensor(v) for k, v in st.items()}, size=2)
        want.append(st, size=4)
        got.append(st, size=4)
    assert isinstance(got.sums["loss"], torch.Tensor)
    for k in keys:
        assert float(got.sums[k]) == float(want.sums[k])
    assert got.series == want.series
    got.reset_sums()
    assert got.sums == {k: 0.0 for k in keys}
