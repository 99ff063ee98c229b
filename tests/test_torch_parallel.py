"""Data-parallel training in the port on the CPU: two gloo ranks against
one device, and against the JAX package's data-parallel step.

The ranks are two processes in one group, started once for the module
(:class:`RankPool`), each capped at one intra-op thread; they run this
module's top-level ``_rank_*`` functions, which import no JAX. Every input
is made from a numpy seed in the test and shipped to both ranks whole;
each rank keeps its rows (``process_shard``, ``shard_or_replicate``) and
the one-device result is the same function run here, outside a group.

* ``BatchNorm2d`` synchronized: outputs, input, weight and bias gradients
  and the running statistics at rtol 1e-5 (a gradient's elements with an
  absolute 1e-5 of its largest: they are sums of cancelling terms), at 2
  ranks and at 1 rank under a group (the synced path) against no group
  (``F.batch_norm``).
* The triplet step with augmentation V1 and the paired flip on: the
  finished batch bit for bit (the draws are the global batch's), losses
  at rtol 1e-5 from the float64 step (the one-device float32 step's own
  lie about 1e-5 from it), the gradient by JAX's data-parallel rule
  against one float32 device (SGD at lr 1,
  so the parameter change is the gradient: relative L2 below 1e-2,
  cosine above 0.9999, ``tests/test_sharding.py:62-71``) and the running
  statistics equal on both ranks bit for bit.
* The same step without augmentation against JAX's ``make_train_step``
  under ``data_mesh(2)``, from one reference-layout state dict: losses at
  rtol 1e-5 with an absolute 1e-5 (``tests/test_torch_train.py``'s bound
  of the port's losses against JAX's), the gradient by the same rule.
* pix2pix (``ngf`` = ``ndf`` = 8, 32 px, batch 8, dropout on, two steps)
  and the VAE (``z_size`` 8, ``dec_rnn_size`` 16, 3 mixtures, 10 rows,
  two steps) against one device at JAX's bounds
  (``tests/test_sharding.py:184-256``), each with a ragged eval of 5
  rows, which every rank computes whole.
* ``mesh_from_args``, ``batch_rows``, ``shard_or_replicate`` and the
  multihost helpers on one process and on two ranks; a rank that raises
  makes ``spawn`` raise within seconds rather than hang.
"""

import datetime
import queue
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from art_sbir_tpu_torch.models import resnet as R
from art_sbir_tpu_torch.parallel import mesh as M
from art_sbir_tpu_torch.parallel import multihost as MH
from art_sbir_tpu_torch.train import triplet as PT
from art_sbir_tpu_torch.train.gan import Pix2Pix, Pix2PixConfig
from art_sbir_tpu_torch.train.losses import TripletLossConfig
from art_sbir_tpu_torch.train.prepare import finish_triplet_batch
from art_sbir_tpu_torch.train.vae import VAEConfig, VAETrainer
from tests.torch_threads import two_torch_threads  # noqa: F401

WORLD = 2
TIMEOUT = datetime.timedelta(seconds=120)
# tests/test_torch_resnet.py's thin geometry
LAYERS, WIDTH, HEADS, OUT_DIM, RES = (2, 1, 1, 1), 8, 4, 32, 64
B = 8
LOSS_TOL = dict(rel=1e-5, abs=1e-6)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ the ranks


def _serve(rank, world, store, inbox, outbox):
    torch.set_num_threads(1)
    MH.init_group(rank, world, torch.device("cpu"), "gloo",
                  dist.FileStore(store, world), TIMEOUT)
    while True:
        task = inbox.get()
        if task is None:
            break
        fn, args = task
        try:
            outbox.put((rank, True, fn(*args)))
        except Exception:
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks on the CPU that run functions on request."""

    def __init__(self, world: int = WORLD):
        ctx = torch.multiprocessing.get_context("spawn")
        self.folder = tempfile.TemporaryDirectory()
        store = str(Path(self.folder.name) / "store")
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, store, self.inboxes[r],
                                        self.outbox))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout: float = 240.0) -> list:
        """``fn(*args)`` on every rank; their results by rank."""
        for box in self.inboxes:
            box.put((fn, args))
        out = {}
        for _ in self.inboxes:
            try:
                rank, ok, value = self.outbox.get(timeout=timeout)
            except queue.Empty:
                raise AssertionError(f"no answer from the ranks in "
                                     f"{timeout} s") from None
            if not ok:
                raise AssertionError(f"rank {rank} raised:\n{value}")
            out[rank] = value
        return [out[r] for r in range(len(self.inboxes))]

    def close(self) -> None:
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        self.folder.cleanup()


@pytest.fixture(scope="module")
def pool():
    p = RankPool()
    yield p
    p.close()


class one_rank_group:
    """This process as the one rank of a gloo group, left on exit."""

    def __enter__(self):
        self.folder = tempfile.TemporaryDirectory()
        MH.init_group(0, 1, torch.device("cpu"), "gloo",
                      dist.FileStore(str(Path(self.folder.name) / "s"), 1),
                      TIMEOUT)

    def __exit__(self, *exc):
        dist.destroy_process_group()
        self.folder.cleanup()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


# ------------------------------------------------------------ BatchNorm


def _rank_bn(x: np.ndarray, g: np.ndarray) -> dict:
    """BatchNorm2d in train mode on this rank's rows of ``x``; the loss
    sum(out * g) backward."""
    c = x.shape[1]
    bn = R.BatchNorm2d(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, c))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, c))
    sl = MH.process_shard(len(x))
    xt = torch.from_numpy(x[sl]).requires_grad_()
    with MH.synced_batchnorm(bn):
        out = bn(xt)
        out2 = bn(xt * 2.0 + 1.0)  # a second call: the statistics chain
    (out * torch.from_numpy(g[sl]) + out2).sum().backward()
    return {"out": _np(out), "x_grad": _np(xt.grad),
            "w_grad": _np(bn.weight.grad), "b_grad": _np(bn.bias.grad),
            "mean": _np(bn.running_mean), "var": _np(bn.running_var)}


def _bn_inputs():
    rng = np.random.default_rng(11)
    x = (3.0 + 2.0 * rng.standard_normal((B, 6, 5, 7))).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, g


def _assert_bn(parts, want):
    got_out = np.concatenate([p["out"] for p in parts])
    got_xg = np.concatenate([p["x_grad"] for p in parts])
    np.testing.assert_allclose(got_out, want["out"], rtol=1e-5, atol=1e-5)
    # a gradient is a sum of cancelling terms: its elements keep the
    # float32 error of the largest (atol scaled by the vector's largest)
    np.testing.assert_allclose(got_xg, want["x_grad"], rtol=1e-5,
                               atol=1e-5 * np.abs(want["x_grad"]).max())
    # each rank holds its rows' share of the parameter gradients
    for k in ("w_grad", "b_grad"):
        np.testing.assert_allclose(sum(p[k] for p in parts), want[k],
                                   rtol=1e-5,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)
    for p in parts:
        for k in ("mean", "var"):
            np.testing.assert_allclose(p[k], want[k], **STATS_TOL,
                                       err_msg=k)
            assert np.array_equal(p[k], parts[0][k]), k


def test_synced_batchnorm_two_ranks(pool):
    x, g = _bn_inputs()
    _assert_bn(pool.run(_rank_bn, x, g), _rank_bn(x, g))


def test_synced_batchnorm_one_rank_matches_no_group():
    x, g = _bn_inputs()
    want = _rank_bn(x, g)  # F.batch_norm
    with one_rank_group():
        got = _rank_bn(x, g)  # the all-reduce path
    _assert_bn([got], want)


# ----------------------------------------------------------- the triplet


def _port_encoder(sd: dict) -> torch.nn.Module:
    model = R.ModifiedResNet(compute_dtype=torch.float32, layers=LAYERS,
                             output_dim=OUT_DIM, heads=HEADS,
                             input_resolution=RES, width=WIDTH)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


def _rank_triplet(sd: dict, batch: dict, augment: bool,
                  dtype: torch.dtype = torch.float32) -> dict:
    """One SGD(lr 1) triplet step on this rank's rows of the uint8 (or
    float) ``batch``, augmented (V1 and the paired flip) from a seeded
    generator when ``augment``, in ``dtype``."""
    model = _port_encoder(sd).to(dtype)
    model.compute_dtype = dtype
    state = PT.TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0))
    before = {k: _np(p) for k, p in model.named_parameters()}
    sl = MH.process_shard(B)
    local = {k: torch.from_numpy(v[sl]) for k, v in batch.items()}
    if augment:
        rows = (sl.start, B) if MH.is_parallel() else None
        local = finish_triplet_batch(
            local, torch.Generator().manual_seed(5), augment_version=1,
            flip=True, train=True, rows=rows)
    local = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in local.items()}
    losses = PT.make_train_step(TripletLossConfig())(state, local)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "sketch": _np(local["sketch"]),
            "grad": {k: before[k] - _np(p)
                     for k, p in model.named_parameters()},
            "stats": {k: _np(v) for k, v in model.state_dict().items()
                      if "running_" in k}}


def _sd(seed: int = 0) -> dict:
    from tests.test_torch_resnet import _sd as reference_sd

    return reference_sd(np.random.default_rng(seed))


def _assert_gradient(got: dict, want: dict):
    """JAX's data-parallel rule over the whole gradient vector."""
    g1 = np.concatenate([want[k].ravel() for k in sorted(want)])
    g2 = np.concatenate([got[k].ravel() for k in sorted(want)])
    rel_l2 = np.linalg.norm(g1 - g2) / np.linalg.norm(g1)
    cos = np.dot(g1, g2) / (np.linalg.norm(g1) * np.linalg.norm(g2))
    assert rel_l2 < 1e-2, rel_l2
    assert cos > 0.9999, cos


def _assert_ranks(parts, want, exact):
    for p in parts:
        for k, v in exact["losses"].items():
            assert p["losses"][k] == pytest.approx(v, rel=1e-5), k
        _assert_gradient(p["grad"], want["grad"])
        for k, v in p["stats"].items():
            assert np.array_equal(v, parts[0]["stats"][k]), k
            np.testing.assert_allclose(v, want["stats"][k], **STATS_TOL,
                                       err_msg=k)
        for k in p["grad"]:
            assert np.array_equal(p["grad"][k], parts[0]["grad"][k]), k


def test_triplet_step_with_augmentation_matches_one_device(pool):
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, 256, (B, RES, RES, 3), dtype=np.uint8)
             for k in ("sketch", "positive", "negative")}
    sd = _sd()
    want = _rank_triplet(sd, batch, True)
    parts = pool.run(_rank_triplet, sd, batch, True)
    # the global batch's draws: each rank's rows are one device's rows
    assert np.array_equal(np.concatenate([p["sketch"] for p in parts]),
                          want["sketch"])
    # the losses against float64: one float32 device's own lie about
    # 1e-5 from it (a margin loss keeps its distances' absolute error)
    _assert_ranks(parts, want, _rank_triplet(sd, batch, True, torch.float64))


def test_triplet_step_matches_jax_data_parallel(pool):
    import jax
    import jax.numpy as jnp
    import optax

    from art_sbir_tpu.parallel import data_mesh, replicated, shard_batch
    from art_sbir_tpu.train import triplet as JT
    from art_sbir_tpu.train.losses import TripletLossConfig as JaxCfg
    from art_sbir_tpu_torch.models import port_weights as PW
    from tests.test_torch_resnet import _flax

    sd = _sd(1)
    rng = np.random.default_rng(4)
    batch = {k: rng.standard_normal((B, RES, RES, 3)).astype(np.float32)
             for k in ("sketch", "positive", "negative")}
    model, params, stats = _flax(sd)
    tx = optax.sgd(1.0)
    state = JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=stats, opt_state=tx.init(params),
                          apply_fn=model.apply, tx=tx)
    mesh = data_mesh(2)
    new, losses = JT.make_train_step(JaxCfg(), donate=False)(
        jax.device_put(state, replicated(mesh)), shard_batch(mesh, batch))
    delta = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   params, new.params)
    want = {k: v.numpy() for k, v in
            PW.modified_resnet_from_flax(delta, stats, LAYERS).items()
            if "running_" not in k and "num_batches" not in k}

    parts = pool.run(_rank_triplet, sd, batch, False)
    for p in parts:
        # tests/test_torch_train.py's loss bound of the port against JAX:
        # a margin loss keeps its distances' absolute float32 error
        assert p["losses"]["loss"] == pytest.approx(float(losses["loss"]),
                                                    rel=1e-5, abs=1e-5)
        _assert_gradient(p["grad"], want)


# ------------------------------------------------------------ pix2pix


def _rank_pix2pix(batch: dict, ragged: dict) -> dict:
    m = Pix2Pix(Pix2PixConfig(image_size=32, ngf=8, ndf=8), seed=0,
                device="cpu")
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for seed in (1, 2):
        local, rows = M.shard_or_replicate(t)
        losses.append({k: float(v) for k, v in
                       m.train_step(local, seed, rows=rows).items()})
    local, _ = M.shard_or_replicate({k: torch.from_numpy(v)
                                     for k, v in ragged.items()})
    state = {f"{n}.{k}": _np(v) for n, net in (("g", m.net_g), ("d", m.net_d))
             for k, v in net.state_dict().items()}
    return {"losses": losses, "state": state,
            "eval": {k: float(v) for k, v in m.eval_losses(local).items()}}


def test_pix2pix_matches_one_device(pool):
    rng = np.random.default_rng(5)
    batch = {"A": rng.random((B, 3, 32, 32)).astype(np.float32),
             "B": rng.random((B, 1, 32, 32)).astype(np.float32)}
    ragged = {k: v[:5] for k, v in batch.items()}
    want = _rank_pix2pix(batch, ragged)
    parts = pool.run(_rank_pix2pix, batch, ragged)
    for p in parts:
        for got_l, want_l in zip(p["losses"], want["losses"]):
            for k, v in want_l.items():
                assert got_l[k] == pytest.approx(v, **LOSS_TOL), k
        for k, v in want["eval"].items():
            assert p["eval"][k] == pytest.approx(v, rel=1e-5), k
        # Adam turns float noise in a gradient into up to 2 lr of drift
        # over two steps (tests/test_sharding.py:213-219)
        for k, v in want["state"].items():
            np.testing.assert_allclose(p["state"][k], v, rtol=1e-3,
                                       atol=5e-5, err_msg=k)
            assert np.array_equal(p["state"][k], parts[0]["state"][k]), k


# ---------------------------------------------------------------- VAE


def _rank_vae(batch: dict, ragged: dict) -> dict:
    t = VAETrainer(VAEConfig(z_size=8, dec_rnn_size=16, num_mixture=3,
                             max_seq_len=10, image_size=32), 0, "cpu")
    losses = []
    for seed in (1, 2):
        local, rows = M.shard_or_replicate(
            {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append({k: float(v) for k, v in
                       t.train_step(local, seed, rows).items()})
    local, rows = M.shard_or_replicate(
        {k: torch.from_numpy(v) for k, v in ragged.items()})
    return {"losses": losses,
            "eval": {k: float(v) for k, v in
                     t.eval_step(local, 9, rows).items()},
            "norm": float(t.grad_norm)}


def test_vae_matches_one_device(pool):
    rng = np.random.default_rng(6)
    batch = {"photo": rng.random((B, 3, 32, 32)).astype(np.float32),
             "sketch_vector": rng.random((B, 10, 5)).astype(np.float32)}
    ragged = {k: v[:5] for k, v in batch.items()}
    want = _rank_vae(batch, ragged)
    for p in pool.run(_rank_vae, batch, ragged):
        for got_l, want_l in zip(p["losses"], want["losses"]):
            for k, v in want_l.items():
                assert got_l[k] == pytest.approx(v, **LOSS_TOL), k
        for k, v in want["eval"].items():
            assert p["eval"][k] == pytest.approx(v, rel=1e-5), k
        # the clip read the reduced gradient's norm
        assert p["norm"] == pytest.approx(want["norm"], rel=1e-4)


# ------------------------------------------------------- rows and mesh


def test_mesh_from_args_semantics():
    assert M.mesh_from_args(1, device="cpu") is None
    assert M.mesh_from_args(0, device="cpu") is None
    assert M.mesh_from_args(-1, device="cpu").size == 1
    mesh = M.mesh_from_args(2, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 2
    # tensor parallelism: the (data, model) grid, single host as JAX's
    grid = M.mesh_from_args(2, 4, device="cpu")
    assert (grid.n_data, grid.n_model, grid.size) == (2, 4, 8)
    with pytest.raises(SystemExit, match="single-host"):
        M.mesh_from_args(2, 4, device="cpu", multihost=True)


def test_mesh_from_args_exits_with_fewer_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="wants 2 devices, only 1 present"):
        M.mesh_from_args(2)


def test_batch_rows_and_shard_or_replicate():
    assert M.batch_rows(8, 1, 2) == slice(4, 8)
    assert M.batch_rows(5, 1, 2) == slice(0, 5)  # ragged: replicated
    batch = {"x": torch.arange(12.0).reshape(6, 2), "w": torch.tensor(0.5)}
    local, rows = M.shard_or_replicate(batch, 2, 3)
    assert torch.equal(local["x"], batch["x"][4:6]) and rows == (4, 6)
    assert local["w"] is batch["w"]  # 0-d entries stay whole
    local, rows = M.shard_or_replicate({"x": batch["x"][:5]}, 1, 2)
    assert local["x"].shape[0] == 5 and rows == (0, 5)
    local, rows = M.shard_or_replicate(batch)  # one process: everything
    assert torch.equal(local["x"], batch["x"]) and rows == (0, 6)


def test_multihost_helpers_single_process(monkeypatch):
    """The counterpart of tests/test_sharding.py:156-181: on one process
    every helper is a no-op or the whole batch."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert MH.initialize("cpu") is None and not MH.is_parallel()
    assert (MH.rank(), MH.world_size()) == (0, 1)
    assert MH.process_shard(8) == slice(0, 8)
    batch = {"x": np.arange(16.0).reshape(16, 1)}
    assert np.array_equal(MH.local_batch_slice(batch)["x"], batch["x"])
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    MH.reduce_gradients([p])
    MH.broadcast_state(torch.nn.Linear(2, 2))
    MH.barrier()
    assert torch.equal(p.grad, torch.full((3,), 2.0))
    losses = {"loss": torch.tensor(1.5)}
    assert MH.mean_over_ranks(losses) is losses
    assert MH.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert MH.choose_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert MH.choose_backend(["cpu", "cpu"]) == "gloo"


def _rank_helpers() -> dict:
    p = torch.nn.Parameter(torch.zeros(3, dtype=torch.float64))
    p.grad = torch.full((3,), float(MH.rank() + 1), dtype=torch.float64)
    q = torch.nn.Parameter(torch.zeros(2))
    q.grad = torch.full((2,), 4.0 * MH.rank())
    MH.reduce_gradients([p, q])
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(MH.rank() + 7.0)
    opt = torch.optim.Adam(lin.parameters())
    lin(torch.ones(1, 2)).sum().backward()
    opt.step()
    with torch.no_grad():
        for st in opt.state.values():
            st["exp_avg"].fill_(MH.rank())
    MH.broadcast_state(lin, opt)
    try:
        MH.process_shard(5)
        ragged = None
    except ValueError as e:
        ragged = str(e)
    return {"rank": MH.rank(), "world": MH.world_size(),
            "shard": MH.process_shard(8),
            "local": MH.local_batch_slice({"x": np.arange(8)})["x"],
            "p": _np(p.grad), "q": _np(q.grad), "w": _np(lin.weight),
            "exp_avg": [_np(st["exp_avg"]) for st in opt.state.values()],
            "mean": float(MH.mean_over_ranks(
                {"l": torch.tensor(float(MH.rank()))})["l"]),
            "ragged": ragged}


def test_multihost_helpers_two_ranks(pool):
    r0, r1 = pool.run(_rank_helpers)
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)
    assert (r0["shard"], r1["shard"]) == (slice(0, 4), slice(4, 8))
    assert list(r1["local"]) == [4, 5, 6, 7]
    for r in (r0, r1):
        assert np.array_equal(r["p"], [1.5] * 3)  # mean of 1 and 2
        assert np.array_equal(r["q"], [2.0] * 2)
        assert np.array_equal(r["w"], r0["w"])  # rank 0's, after its step
        np.testing.assert_allclose(r["w"], np.full((2, 2), 6.999))
        assert all(np.array_equal(a, np.zeros_like(a))
                   for a in r["exp_avg"])
        assert r["mean"] == 0.5
        assert "not divisible by 2 ranks" in r["ragged"]


def _fail_on_rank1(device):
    if MH.rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    MH.barrier()  # would wait for rank 1 until the group's timeout


def test_a_failing_rank_fails_spawn_quickly():
    t0 = time.perf_counter()
    # rank 1's error, or rank 0's at the barrier its departure broke
    with pytest.raises(Exception, match="terminated with the following"):
        MH.spawn(_fail_on_rank1, ["cpu", "cpu"],
                 timeout=datetime.timedelta(seconds=60))
    assert time.perf_counter() - t0 < 60
