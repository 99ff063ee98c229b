"""The port's tensor-parallel steps against the JAX package's
single-device steps, in float32 on the CPU.

Two gloo ranks (a 1 x 2 grid, ``tests/test_torch_parallel.py``'s
:class:`RankPool`) run this module's top-level ``_rank_*`` functions,
which import no JAX. The weights are JAX's, carried into the port by
``models/port_weights.py``'s ``*_from_flax``; the inputs are numpy-seeded
and shipped to both ranks. JAX's tolerances
(``tests/test_sharding.py:307-350,442-491``): the losses at rel 1e-4, abs
1e-5; a gradient by JAX's data-parallel rule (relative L2 below 1e-2,
cosine above 0.9999) over the whole flat vector.

* The triplet step (SGD at lr 1: the parameter change is the gradient)
  on ``tests/test_torch_resnet.py``'s thin encoder, from a reference
  layout state dict.
* One pix2pix step of the thin ResNet G and the basic D (dropout off: the
  two packages' dropout streams differ), JAX's ``define_g`` patched to the
  thin net as ``tests/test_torch_pix2pix.py`` does.
* The VAE's losses and gradient, JAX's noise fed to the port as ``eps``.
"""

import numpy as np
import pytest
import torch

from art_sbir_tpu_torch.models import pix2pix as PP
from art_sbir_tpu_torch.models import resnet as R
from art_sbir_tpu_torch.parallel import multihost as MH
from art_sbir_tpu_torch.parallel import tensor as T
from art_sbir_tpu_torch.train import triplet as PT
from art_sbir_tpu_torch.train.gan import Pix2Pix, Pix2PixConfig
from art_sbir_tpu_torch.train.losses import TripletLossConfig
from art_sbir_tpu_torch.train.vae import VAEConfig, VAETrainer
from tests.test_torch_parallel import RankPool
from tests.torch_threads import two_torch_threads  # noqa: F401

# tests/test_torch_resnet.py's geometry; tests/test_torch_pix2pix.py's
# thin G; tests/test_torch_photo2sketch.py's VAE at 32 px
GEOM = dict(layers=(2, 1, 1, 1), width=8, heads=4, output_dim=32,
            input_resolution=64)
NGF, BLOCKS = 8, 2
VAE = dict(z_size=8, dec_rnn_size=16, num_mixture=3, max_seq_len=10,
           image_size=32)
LOSS = dict(rel=1e-4, abs=1e-5)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


def _gradients(model: torch.nn.Module) -> dict:
    """Every parameter's gradient in one device's layout."""
    lay = T.layout(model)
    out = {}
    for k, p in model.named_parameters():
        g = p.grad
        if lay is not None and k in lay.dims:
            g = lay.shard.all_gather(g, lay.dims[k])
        out[k] = g.detach().numpy().copy()
    return out


def _shard():
    MH.init_grid(2)
    return T.model_shard()


def _rank_triplet(sd: dict, batch: dict) -> dict:
    model = R.ModifiedResNet(compute_dtype=torch.float32, **GEOM)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    T.tensor_parallel(model, _shard())
    state = PT.TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0))
    losses = PT.make_train_step(TripletLossConfig())(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"loss": float(losses["loss"]), "grad": _gradients(model)}


def _rank_pix2pix(g_sd: dict, d_sd: dict, batch: dict) -> dict:
    m = Pix2Pix(Pix2PixConfig(image_size=32, ngf=NGF, ndf=NGF,
                              use_dropout=False), device="cpu")
    m.net_g = PP.ResnetGenerator(3, 1, NGF, BLOCKS, "batch", False)
    for net, sd in ((m.net_g, g_sd), (m.net_d, d_sd)):
        own = net.state_dict()
        net.load_state_dict({**own, **{k: torch.from_numpy(v)
                                       for k, v in sd.items()}})
    m._optimizers()
    m.tensor_parallel(_shard())
    losses = m.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                          1)
    return {k: float(v) for k, v in losses.items()}


def _rank_vae(sd: dict, batch: dict, eps: np.ndarray) -> dict:
    t = VAETrainer(VAEConfig(**VAE), device="cpu")
    t.model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    t.tensor_parallel(_shard())
    losses = t.compute_gradients(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(eps))
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grad": _gradients(t.model)}


def _assert_gradient(got: dict, want: dict) -> None:
    g1 = np.concatenate([want[k].ravel() for k in sorted(want)])
    g2 = np.concatenate([got[k].ravel() for k in sorted(want)])
    rel_l2 = np.linalg.norm(g1 - g2) / np.linalg.norm(g1)
    cos = np.dot(g1, g2) / (np.linalg.norm(g1) * np.linalg.norm(g2))
    assert rel_l2 < 1e-2, rel_l2
    assert cos > 0.9999, cos


def test_triplet_step_matches_jax_single_device(pool):
    import jax
    import jax.numpy as jnp
    import optax

    from art_sbir_tpu.train import triplet as JT
    from art_sbir_tpu.train.losses import TripletLossConfig as JaxCfg
    from art_sbir_tpu_torch.models import port_weights as PW
    from tests.test_torch_parallel import _sd
    from tests.test_torch_resnet import _flax

    sd = _sd(2)
    rng = np.random.default_rng(5)
    batch = {k: rng.standard_normal((8, 64, 64, 3)).astype(np.float32)
             for k in ("sketch", "positive", "negative")}
    model, params, stats = _flax(sd)
    tx = optax.sgd(1.0)
    state = JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=stats, opt_state=tx.init(params),
                          apply_fn=model.apply, tx=tx)
    new, losses = JT.make_train_step(JaxCfg(), donate=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    delta = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   params, new.params)
    want = {k: v.numpy() for k, v in
            PW.modified_resnet_from_flax(delta, stats, GEOM["layers"]).items()
            if "running_" not in k and "num_batches" not in k}
    for got in pool.run(_rank_triplet, sd, batch):
        assert got["loss"] == pytest.approx(float(losses["loss"]), **LOSS)
        _assert_gradient(got["grad"], want)


def test_pix2pix_step_matches_jax_single_device(pool, monkeypatch):
    import jax
    import jax.numpy as jnp

    from art_sbir_tpu.models import pix2pix as JP
    from art_sbir_tpu.train import gan as JG
    from art_sbir_tpu_torch.models import port_weights as PW

    monkeypatch.setattr(JG, "define_g", lambda net, oc, ngf, norm, drop,
                        dtype=None: JP.ResnetGenerator(oc, ngf, BLOCKS, norm,
                                                       drop, dtype))
    jm = JG.Pix2Pix(JG.Pix2PixConfig(image_size=32, ngf=NGF, ndf=NGF,
                                     use_dropout=False), jax.random.key(0))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    g_sd = PW.pix2pix_g_from_flax("resnet_9blocks", as_np(jm.g.params),
                                  as_np(jm.g.batch_stats), n_blocks=BLOCKS)
    d_sd = PW.pix2pix_d_from_flax("basic", as_np(jm.d.params),
                                  as_np(jm.d.batch_stats))
    rng = np.random.default_rng(6)
    a = rng.random((4, 32, 32, 3)).astype(np.float32)
    b = rng.random((4, 32, 32, 1)).astype(np.float32)
    want = jm.train_step({"A": jnp.asarray(a), "B": jnp.asarray(b)},
                         jax.random.key(1))
    batch = {"A": np.ascontiguousarray(a.transpose(0, 3, 1, 2)),
             "B": np.ascontiguousarray(b.transpose(0, 3, 1, 2))}
    for got in pool.run(_rank_pix2pix, {k: v.numpy() for k, v in g_sd.items()},
                        {k: v.numpy() for k, v in d_sd.items()}, batch):
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(float(v), **LOSS), k


def test_vae_step_matches_jax_single_device(pool):
    import jax
    import jax.numpy as jnp

    from art_sbir_tpu.train import vae as JV
    from art_sbir_tpu_torch.models.port_weights import photo2sketch_from_flax
    from tests.test_torch_photo2sketch import port_grads

    jt = JV.VAETrainer(JV.VAEConfig(**VAE), jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    rng = np.random.default_rng(7)
    photo = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    vec = rng.standard_normal((4, 10, 5)).astype(np.float32)
    key = jax.random.key(1)
    (_, losses), grads = jax.jit(jax.value_and_grad(
        lambda p: jt._losses(p, {"photo": jnp.asarray(photo),
                                 "sketch_vector": jnp.asarray(vec)},
                             key, jt.state.step), has_aux=True))(params)
    eps = np.asarray(jax.random.normal(key, (4, VAE["z_size"])))
    want = {k: v.numpy() for k, v in port_grads(
        jax.tree_util.tree_map(np.asarray, grads)).items()}
    sd = {k: v.numpy() for k, v in photo2sketch_from_flax(params).items()}
    batch = {"photo": np.ascontiguousarray(photo.transpose(0, 3, 1, 2)),
             "sketch_vector": vec}
    for got in pool.run(_rank_vae, sd, batch, eps):
        for k, v in got["losses"].items():
            assert v == pytest.approx(float(losses[k]), **LOSS), k
        _assert_gradient(got["grad"], want)
