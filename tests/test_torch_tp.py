"""Tensor parallelism in the port on the CPU: the sharding rule against
JAX's ``tp_spec``, and gloo ranks of a ``(data, model)`` grid against one
process, in float64.

The ranks are processes of one group started once for the module
(``tests/test_torch_parallel.py``'s :class:`RankPool`, one intra-op thread
each): two (a 1 x 2 grid) and four (2 x 2, the triplet step). They run this
module's top-level ``_rank_*`` functions, which import no JAX; the
one-process result is the same function run here, outside a group. The
shapes are JAX's test shapes (``tests/test_sharding.py:281-283,449,
475-476``): ``layers`` (1, 1, 1, 1), ``width`` 8, 32 px, ``ngf`` = ``ndf`` =
8, the VAE at ``z_size`` 8, ``dec_rnn_size`` 16, 3 mixtures, 10 rows.

* The rule: for the encoder with both heads, pix2pix's G and D and the
  VAE at ``n_model`` 2 and 4, the port's entries that ``tp_dim`` shards
  are, name for name through ``models/port_weights.py``'s ``*_from_flax``,
  the leaves JAX's ``tp_spec`` shards (a transposed conv's kernel on its
  input channels: flax's is ``(kh, kw, out, in)``); JAX's own cases
  (``tests/test_sharding.py:259-271``) in the port's layouts.
* The mechanism, float64: the encoder's forward; one SGD(lr 1) triplet
  step on a 2 x 2 grid (so the parameter change is the gradient); two
  pix2pix steps (the U-Net with dropout, and the ResNet G); two VAE
  steps. Losses, gradients or parameters, Adam's moments and the
  BatchNorm statistics, gathered, at rtol 1e-9 (an absolute 1e-12 for
  the gradients that cancel exactly, the attention pool's biases, whose
  elements are rounding noise). Each rank holds exactly its slice: every
  entry's shape, and the bytes of parameters, Adam state and buffers
  against one process's; each sharded conv and linear computes its
  slice of the output channels only (read before the gather; a sharded
  transposed conv holds its input channels' rows of the kernel).
  pix2pix's gathered state (both nets and Adam states) loads back into
  a fresh grid's slices bit for bit.
"""

import numpy as np
import pytest
import torch

from art_sbir_tpu_torch.models import flax_families
from art_sbir_tpu_torch.models import pix2pix as PP
from art_sbir_tpu_torch.models import resnet as R
from art_sbir_tpu_torch.parallel import mesh as M
from art_sbir_tpu_torch.parallel import multihost as MH
from art_sbir_tpu_torch.parallel import tensor as T
from art_sbir_tpu_torch.train import triplet as PT
from art_sbir_tpu_torch.train.gan import Pix2Pix, Pix2PixConfig
from art_sbir_tpu_torch.train.losses import TripletLossConfig
from art_sbir_tpu_torch.train.vae import VAEConfig, VAETrainer
from tests.test_torch_parallel import RankPool
from tests.torch_threads import two_torch_threads  # noqa: F401

GEOM = dict(layers=(1, 1, 1, 1), width=8, heads=4, output_dim=16,
            input_resolution=32)
VAE = dict(z_size=8, dec_rnn_size=16, num_mixture=3, max_seq_len=10,
           image_size=32)
B = 8
EXACT = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def pool2():
    p = RankPool(2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4():
    p = RankPool(4)
    yield p
    p.close()


# ------------------------------------------------------------ the ranks


def _shard(n_model: int = 2):
    """This rank's model shard (a grid of ``n_model`` made on first use),
    or None outside a group."""
    if MH.is_parallel():
        MH.init_grid(n_model)
    return T.model_shard()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _encoder() -> torch.nn.Module:
    """The thin encoder in float64, seeded, its BatchNorms off identity."""
    model = R.init_weights(R.ModifiedResNet(**GEOM), 3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, R.BatchNorm2d):
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0.0, 0.1, generator=gen)
                mod.running_mean.normal_(0.0, 0.1, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
    model.compute_dtype = torch.float64
    return model.double()


def _layout(model: torch.nn.Module, opt=None) -> dict:
    """What this rank holds: each entry's shape, the bytes, and the output
    channels each sharded conv and linear computed (recorded by
    :func:`_record_local`)."""
    return {"shapes": {k: tuple(v.shape)
                       for k, v in model.state_dict().items()},
            "bytes": T.held_bytes(model, opt),
            "local": dict(getattr(model, "_local_out", {}))}


def _record_local(model: torch.nn.Module) -> None:
    """Record each sharded conv's and linear's own output channels, read
    before the swap's gather (a hook put in front of it)."""
    model._local_out = {}
    lay = T.layout(model)
    for name, mod in model.named_modules():
        if lay is not None and f"{name}.weight" in lay.dims and isinstance(
                mod, (torch.nn.Conv2d, torch.nn.Linear)):
            dim = -1 if isinstance(mod, torch.nn.Linear) else 1

            def hook(m, args, out, name=name, dim=dim):
                model._local_out[name] = out.shape[dim]
            mod.register_forward_hook(hook, prepend=True)


def _moments(model, opt) -> dict:
    """Adam's moments in one device's layout, by parameter name."""
    names = [k for k, _ in model.named_parameters()]
    state = T.gather_optimizer_state(model, opt)["state"]
    return {names[i]: (_np(st["exp_avg"]), _np(st["exp_avg_sq"]))
            for i, st in state.items()}


def _rank_encoder(x: np.ndarray) -> dict:
    model = _encoder().eval()
    T.tensor_parallel(model, _shard())
    _record_local(model)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return {"out": _np(out), **_layout(model)}


def _rank_triplet(batch: dict, n_model: int) -> dict:
    """One SGD(lr 1) triplet step on this rank's rows (by its data
    index): the losses, the gradient and the state, gathered."""
    model = _encoder()
    T.tensor_parallel(model, _shard(n_model))
    _record_local(model)
    before = {k: v.clone() for k, v in T.gather_state(model).items()}
    state = PT.TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0))
    sl = MH.process_shard(B)
    local = {k: torch.from_numpy(v[sl]) for k, v in batch.items()}
    losses = PT.make_train_step(TripletLossConfig())(state, local)
    after = state.state_dict()["model"]
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grad": {k: _np(before[k] - after[k])
                     for k, _ in model.named_parameters()},
            "state": {k: _np(v) for k, v in after.items()},
            "rows": (sl.start, sl.stop), **_layout(model)}


def _pix2pix(net: str) -> Pix2Pix:
    """Pix2Pix at ``ngf`` = ``ndf`` = 8, 32 px, dropout on, in float64:
    the ResNet G, or a U-Net of 5 downs (``define_g`` fixes 8)."""
    m = Pix2Pix(Pix2PixConfig(net_g=net, image_size=32, ngf=8, ndf=8),
                seed=0, device="cpu")
    if net == "unet_256":
        m.net_g = PP.UnetGenerator(3, 1, 5, 8, "batch", use_dropout=True)
        m.net_g.load_state_dict(flax_families.pix2pix(1, m.net_g))
    m.net_g.double()
    m.net_d.double()
    m._optimizers()
    return m


def _rank_pix2pix(batch: dict, net: str) -> dict:
    m = _pix2pix(net).tensor_parallel(_shard())
    _record_local(m.net_g)
    _record_local(m.net_d)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for seed in (1, 2):
        local, rows = M.shard_or_replicate(t)
        losses.append({k: float(v) for k, v in
                       m.train_step(local, seed, rows=rows).items()})
    sd = m.state_dict()
    again = _pix2pix(net).tensor_parallel(_shard())  # a resume's load
    again.load_state_dict(sd)
    return {"losses": losses, "reloaded": _equal(again.state_dict(), sd),
            "state": {f"{side}.{k}": _np(v) for side in ("g", "d")
                      for k, v in sd[side]["model"].items()},
            "moments": {f"{side}.{k}": v for side, net_, opt in (
                ("g", m.net_g, m.opt_g), ("d", m.net_d, m.opt_d))
                for k, v in _moments(net_, opt).items()},
            "g": _layout(m.net_g, m.opt_g), "d": _layout(m.net_d, m.opt_d)}


def _equal(a, b) -> bool:
    """Nested dicts and lists of tensors and plain values, bit for bit."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _rank_vae(batch: dict) -> dict:
    t = VAETrainer(VAEConfig(**VAE), 0, "cpu")
    t.model.double()
    t.tensor_parallel(_shard())
    _record_local(t.model)
    losses = []
    for seed in (1, 2):
        local, rows = M.shard_or_replicate(
            {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append({k: float(v) for k, v in
                       t.train_step(local, seed, rows).items()})
    return {"losses": losses, "norm": float(t.grad_norm),
            "state": {k: _np(v) for k, v in
                      T.gather_state(t.model).items()},
            "moments": _moments(t.model, t.optimizer),
            **_layout(t.model, t.optimizer)}


# -------------------------------------------------------------- checks


def _assert_close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **EXACT, err_msg=f"{what} {k}")


def _assert_slices(rank: int, got: dict, model: torch.nn.Module, opt,
                   n: int = 2) -> None:
    """Each entry of ``model`` (one process's) at its slice on the rank,
    and the bytes those slices take; each sharded layer's own output a
    slice of its channels."""
    dims = T.tp_dims(model, n)
    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    want_bytes = {"parameters": 0, "optimizer": 0, "buffers": 0}
    for k, v in model.state_dict().items():
        shape = list(v.shape)
        if k in dims:
            shape[dims[k]] //= n
        assert got["shapes"][k] == tuple(shape), (rank, k)
    for k, p in model.named_parameters():
        want_bytes["parameters"] += size(p) // (n if k in dims else 1)
        if opt is not None:  # Adam: two moments and the step
            want_bytes["optimizer"] += 2 * size(p) // (n if k in dims
                                                       else 1) + 4
    for k, b in model.named_buffers():
        want_bytes["buffers"] += size(b) // (n if k in dims else 1)
    assert got["bytes"] == want_bytes, rank
    assert got["bytes"]["parameters"] < T.held_bytes(model)["parameters"]
    for name, channels in got["local"].items():
        full = model.get_submodule(name).weight.shape[0]
        assert channels == full // n, (rank, name)
    assert got["local"] or not any(k.endswith(".weight") for k in dims)


# ------------------------------------------------------------- the rule


def _marked(tree, n: int):
    """Each leaf of a flax tree as an array of its shape: 2 where JAX's
    ``tp_spec`` shards it over ``n``, else 0 (the LSTM's conversion takes
    1 / sqrt(H) off, which leaves them apart)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from art_sbir_tpu.parallel.tensor import tp_spec

    return jax.tree_util.tree_map(
        lambda leaf: np.full(leaf.shape, 0.0 if tp_spec(leaf, n) == P()
                             else 2.0, np.float32), tree)


def _jax_sharded(model_name: str, n: int):
    """(the port's model, the port's names of the entries JAX shards)."""
    import jax
    import jax.numpy as jnp

    from art_sbir_tpu.models import pix2pix as JP
    from art_sbir_tpu.models.photo2sketch import Photo2Sketch as JaxP2S
    from art_sbir_tpu.models.resnet import (
        ModifiedResNetWithClassification as JaxResNetCls)
    from art_sbir_tpu_torch.models import port_weights as PW
    from art_sbir_tpu_torch.models.photo2sketch import Photo2Sketch

    def shapes(model, x, **kw):
        return jax.eval_shape(lambda k: model.init(k, jnp.zeros(x), **kw),
                              jax.random.key(0))

    if model_name == "encoder":
        v = shapes(JaxResNetCls(num_classes=5, num_classes2=6, **GEOM),
                   (1, 32, 32, 3), train=False)
        sd = PW.modified_resnet_with_classification_from_flax(
            _marked(v["params"], n), _marked(v["batch_stats"], n),
            GEOM["layers"])
        port = R.ModifiedResNetWithClassification(num_classes=5,
                                                  num_classes2=6, **GEOM)
    elif model_name == "pix2pix":
        g = shapes(JP.UnetGenerator(1, 5, 8, "batch", True), (1, 32, 32, 3),
                   train=False)
        d = shapes(JP.NLayerDiscriminator(8), (1, 32, 32, 4), train=False)
        sd = {f"g.{k}": v for k, v in PW.pix2pix_g_from_flax(
            "unet_256", _marked(g["params"], n),
            _marked(g["batch_stats"], n), num_downs=5).items()}
        sd.update({f"d.{k}": v for k, v in PW.pix2pix_d_from_flax(
            "basic", _marked(d["params"], n),
            _marked(d["batch_stats"], n)).items()})
        port = torch.nn.ModuleDict({
            "g": PP.UnetGenerator(3, 1, 5, 8, "batch", True),
            "d": PP.NLayerDiscriminator(4, 8)})
    else:
        cfg = {k: VAE[k] for k in ("z_size", "dec_rnn_size", "num_mixture")}
        v = shapes(JaxP2S(max_seq_len=VAE["max_seq_len"], **cfg),
                   (1, 32, 32, 3), sketch=jnp.zeros((1, 10, 5)),
                   rng=jax.random.key(1))
        sd = PW.photo2sketch_from_flax(_marked(v["params"], n))
        port = Photo2Sketch(**cfg)
    return port, {k for k, t in sd.items() if t.numel() and t.max() > 1}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("model_name", ["encoder", "pix2pix", "vae"])
def test_rule_matches_jax_tp_spec(model_name, n):
    port, want = _jax_sharded(model_name, n)
    dims = T.tp_dims(port, n)
    assert set(dims) == want
    # a mix of both: the 1-output heads, the 5-way classifier, the
    # 123-way mixture head and the LSTM's odd input stay whole
    assert len(want) < len(port.state_dict())
    sd = port.state_dict()
    for k, d in dims.items():
        assert sd[k].shape[d] % n == 0, k


def test_rule_follows_jax_cases():
    """``tests/test_sharding.py:259-271`` in the port's layouts."""
    conv = torch.nn.Conv2d(4, 8, 3)  # flax (3, 3, 4, 8)
    assert T.tp_dim(conv, "weight", conv.weight, 4) == 0
    assert T.tp_dim(conv, "bias", conv.bias, 4) == 0
    bn = torch.nn.BatchNorm2d(8)
    assert T.tp_dim(bn, "running_var", bn.running_var, 4) == 0
    odd = torch.nn.Conv2d(4, 6, 3)  # 6 % 4
    assert T.tp_dim(odd, "weight", odd.weight, 4) is None
    assert T.tp_dim(bn, "num_batches_tracked", bn.num_batches_tracked,
                    4) is None  # a scalar, as Adam's count
    # (in, out, kh, kw); flax's (kh, kw, out, in) trails with the input
    up = torch.nn.ConvTranspose2d(8, 6, 3)
    assert T.tp_dim(up, "weight", up.weight, 4) == 0
    assert T.tp_dim(up, "bias", up.bias, 4) is None  # 6 outputs
    lstm = torch.nn.LSTM(5, 4)  # (4H, in): flax's (in, 4H)
    assert T.tp_dim(lstm, "weight_ih_l0", lstm.weight_ih_l0, 4) == 0
    pool = R.AttentionPool2d(2, 8, 2, 4)
    assert T.tp_dim(pool, "positional_embedding",
                    pool.positional_embedding, 4) == 1
    with pytest.raises(ValueError, match="no tensor-parallel rule"):
        T.tp_dim(torch.nn.PReLU(4), "weight", torch.zeros(4), 2)


# ------------------------------------------------------- the mechanism


def test_encoder_forward_matches_one_process(pool2):
    x = np.random.default_rng(1).standard_normal((4, 32, 32, 3))
    want = _rank_encoder(x)
    for r, got in enumerate(pool2.run(_rank_encoder, x)):
        np.testing.assert_allclose(got["out"], want["out"], **EXACT)
        _assert_slices(r, got, _encoder(), None)


def test_triplet_step_on_a_2x2_grid_matches_one_process(pool4):
    rng = np.random.default_rng(2)
    batch = {k: rng.standard_normal((B, 32, 32, 3))
             for k in ("sketch", "positive", "negative")}
    want = _rank_triplet(batch, 2)
    parts = pool4.run(_rank_triplet, batch, 2)
    # rank d * 2 + m holds the rows of data index d
    assert [p["rows"] for p in parts] == [(0, 4), (0, 4), (4, 8), (4, 8)]
    for r, got in enumerate(parts):
        for k, v in want["losses"].items():
            assert got["losses"][k] == pytest.approx(v, rel=1e-9), k
        _assert_close(got["grad"], want["grad"], "gradient")
        _assert_close(got["state"], want["state"], "state")
        _assert_slices(r, got, _encoder(), None)


@pytest.mark.parametrize("net", ["unet_256", "resnet_9blocks"])
def test_pix2pix_steps_match_one_process(pool2, net):
    rng = np.random.default_rng(3)
    batch = {"A": rng.random((4, 3, 32, 32)), "B": rng.random((4, 1, 32, 32))}
    want = _rank_pix2pix(batch, net)
    one = _pix2pix(net)
    assert want["reloaded"]
    for r, got in enumerate(pool2.run(_rank_pix2pix, batch, net)):
        # the state in one device's layout loads back into the slices
        assert got["reloaded"], r
        for s, (g, w) in enumerate(zip(got["losses"], want["losses"])):
            for k, v in w.items():
                assert g[k] == pytest.approx(v, rel=1e-9, abs=1e-12), (s, k)
        _assert_close(got["state"], want["state"], "state")
        assert set(got["moments"]) == set(want["moments"])
        for k, (m1, m2) in want["moments"].items():
            np.testing.assert_allclose(got["moments"][k][0], m1, **EXACT)
            np.testing.assert_allclose(got["moments"][k][1], m2, rtol=1e-9,
                                       atol=1e-24)
        _assert_slices(r, got["g"], one.net_g, one.opt_g)
        _assert_slices(r, got["d"], one.net_d, one.opt_d)


def test_vae_steps_match_one_process(pool2):
    rng = np.random.default_rng(4)
    batch = {"photo": rng.standard_normal((4, 3, 32, 32)),
             "sketch_vector": rng.standard_normal((4, 10, 5))}
    want = _rank_vae(batch)
    one = VAETrainer(VAEConfig(**VAE), 0, "cpu")
    one.model.double()
    for r, got in enumerate(pool2.run(_rank_vae, batch)):
        for s, (g, w) in enumerate(zip(got["losses"], want["losses"])):
            for k, v in w.items():
                assert g[k] == pytest.approx(v, rel=1e-9), (s, k)
        assert got["norm"] == pytest.approx(want["norm"], rel=1e-9)
        _assert_close(got["state"], want["state"], "state")
        for k, (m1, m2) in want["moments"].items():
            np.testing.assert_allclose(got["moments"][k][0], m1, **EXACT)
            np.testing.assert_allclose(got["moments"][k][1], m2, rtol=1e-9,
                                       atol=1e-24)
        _assert_slices(r, got, one.model, one.optimizer)
