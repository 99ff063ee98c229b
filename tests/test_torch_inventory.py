"""The last modules of the port against the JAX package, on the CPU:
InceptionV3 (through ``inception_v3_from_flax``), the CLIP transformer
block (through ``residual_attention_block_from_flax``), the matmul
bicubic and ``clip_preprocess``, ``gram_matrix``, ``normalize_batch``,
``ReplayBuffer``, the LR schedules, ``RngStream`` and the ``utils``
re-exports.

The same numpy-seeded inputs and weights go through both; the port is
NCHW where JAX is NHWC (InceptionV3, the style helpers) and the tests
transpose. Tolerances are stated in each test: float32 convolutions and
matmuls sum in other orders in the two packages, so the networks agree
to float32 rounding; the host-side pieces (the buffer, the schedules,
the name ids) are held exactly.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu_torch.models import port_weights as PW


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for this module, restored after it: the tier-1
    suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _fill(shapes, rng):
    """A flax variables tree of the given shapes filled from numpy: conv and
    dense kernels N(0, 2 / fan_in) (the signal survives the depth), biases
    and BatchNorm shifts and means N(0, 0.1), scales and variances
    U(0.5, 1.5)."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, (2 / fan_in) ** 0.5, s.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.normal(0, 0.1, s.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(leaf(p, s), jnp.float32), shapes)


@pytest.fixture(scope="module")
def inception_case():
    from art_sbir_tpu.models.inception import InceptionV3

    rng = np.random.default_rng(0)
    x = rng.random((2, 75, 75, 3), dtype=np.float32)
    shapes = jax.eval_shape(
        lambda: InceptionV3(num_classes=10).init(
            jax.random.key(0), jnp.zeros((1, 75, 75, 3)), train=False))
    return x, _fill(shapes, rng)


@pytest.mark.parametrize("every_feat", [False, True])
def test_inception_eval_matches_jax(inception_case, every_feat):
    """Eval mode: logits (and Mixed_6b) within float32 reach of JAX's, rtol
    and atol 1e-4 of values of order 1 after 94 convolutions."""
    from art_sbir_tpu.models.inception import InceptionV3 as JaxV3
    from art_sbir_tpu_torch.models.inception import InceptionV3

    x, v = inception_case
    jm = JaxV3(num_classes=10, every_feat=every_feat)
    logits, second = jax.jit(jm.apply, static_argnames="train")(
        v, jnp.asarray(x), train=False)
    port = InceptionV3(10, use_aux=False, every_feat=every_feat).eval()
    port.load_state_dict(PW.inception_v3_from_flax(v["params"],
                                                   v["batch_stats"]))
    with torch.no_grad():
        got, got2 = port(nchw(x))
    scale = float(np.abs(np.asarray(logits)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=1e-4,
                               atol=1e-4 * scale)
    if every_feat:
        want = np.asarray(second).transpose(0, 3, 1, 2)  # JAX's feat21
        assert got2.shape == (2, 768, 3, 3)
        np.testing.assert_allclose(got2.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    else:
        assert second is None and got2 is None


def test_inception_train_step_matches_jax(inception_case, monkeypatch):
    """Train mode (dropout off, no aux head): the batch-statistics forward
    and the running statistics flax's BatchNorm (eps 1e-3, momentum 0.9)
    leaves. JAX runs flax's two-pass variance (its default one-pass form
    cancels), as the port's BatchNorm computes it. BatchNorm over few
    values (at 107 px the last blocks see 2x2 maps of 4 images) amplifies
    float32 rounding block by block, so both float32 runs are held to
    the port's float64 run by the repo's rule: the port within twice
    JAX's distance from it plus 1e-5 (XLA's float32 sums lie up to 2.6x
    farther than the port's here), JAX within 1e-3 of it."""
    import copy

    import flax.linen.normalization as fnorm

    from art_sbir_tpu.models.inception import InceptionV3 as JaxV3
    from art_sbir_tpu_torch.models.inception import InceptionV3

    orig = fnorm._compute_stats

    def two_pass(*args, **kw):
        kw["use_fast_variance"] = False
        return orig(*args, **kw)

    monkeypatch.setattr(fnorm, "_compute_stats", two_pass)
    _, v = inception_case
    x = np.random.default_rng(4).random((4, 107, 107, 3), dtype=np.float32)
    jm = JaxV3(num_classes=10, use_aux=False, dropout_rate=0.0)
    (logits, aux), upd = jax.jit(
        lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(x))
    port = InceptionV3(10, use_aux=False, dropout_rate=0.0)
    port.load_state_dict(PW.inception_v3_from_flax(v["params"],
                                                   v["batch_stats"]))
    exact = copy.deepcopy(port).double().train()
    with torch.no_grad():
        got, got_aux = port.train()(nchw(x))
        ref, _ = exact(nchw(x).double())
    assert aux is None and got_aux is None
    jax_sd = PW.inception_v3_from_flax(v["params"], upd["batch_stats"])
    pairs = [(got, np.asarray(logits), ref, "logits")]
    for k, t in jax_sd.items():
        if k.endswith(("running_mean", "running_var")):
            pairs.append((port.state_dict()[k], t.numpy(),
                          exact.state_dict()[k], k))
    for mine, theirs, exact_t, what in pairs:
        exact_t = exact_t.numpy()
        d_port = np.abs(mine.numpy() - exact_t).max()
        d_jax = np.abs(theirs - exact_t).max()
        assert d_port <= 2 * d_jax + 1e-5, (what, d_port, d_jax)
        assert d_jax <= 1e-3 * max(1.0, np.abs(exact_t).max()), (what, d_jax)


def test_inception_aux_head_in_train_mode():
    """The aux head runs on Mixed_6e in train mode only, as JAX's does:
    at 299 px its logits are (B, classes); ``every_feat`` makes none."""
    from art_sbir_tpu_torch.models.inception import create_inception

    m = create_inception(num_classes=5, seed=0)
    m.dropout.generator = torch.Generator().manual_seed(0)
    x = torch.rand(2, 3, 299, 299, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, aux = m.train()(x)
        assert logits.shape == aux.shape == (2, 5)
        assert m.eval()(x)[1] is None
    assert create_inception(every_feat=True).AuxLogits is None


@pytest.mark.parametrize("masked", [False, True])
def test_residual_attention_block_matches_jax(masked):
    """The block at rtol 1e-5 against flax's. The mask is JAX's rule: an
    additive float mask keeps a position where it is above -1, so -0.5
    keeps one and -inf or -2 drop it."""
    from art_sbir_tpu.models.transformer import ResidualAttentionBlock
    from art_sbir_tpu_torch.models import transformer as PT

    rng = np.random.default_rng(1)
    d, h, t = 32, 4, 7
    x = rng.normal(size=(2, t, d)).astype(np.float32)
    jm = ResidualAttentionBlock(d_model=d, n_head=h)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                            jnp.zeros((1, t, d))))
    v = _fill(shapes, rng)
    mask = None
    if masked:
        mask = np.triu(np.full((t, t), -np.inf, np.float32), 1)
        mask[3, 1], mask[5, 5] = -2.0, -0.5
    want = jax.jit(jm.apply)(v, jnp.asarray(x),
                             None if mask is None else jnp.asarray(mask))
    port = PT.ResidualAttentionBlock(d, h)
    port.load_state_dict(PW.residual_attention_block_from_flax(v["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # LayerNormFp32 hands back the input's dtype
    half = torch.from_numpy(x).half()
    assert port.ln_1(half).dtype == torch.float16
    assert PT.quick_gelu(torch.tensor([1.0])).item() == pytest.approx(
        float(jax.nn.sigmoid(1.702)), rel=1e-6)


@pytest.mark.parametrize("crop", [False, True])
def test_clip_preprocess_matches_jax(crop):
    """uint8 (B, H, W, 3) -> (B, 24, 24, 3) in both modes within 1e-6 of
    JAX's (values of order 2; both round the passes to uint8 levels); the
    float path of ``resize_bicubic`` at rtol 1e-5."""
    from art_sbir_tpu.ops import resize as JR
    from art_sbir_tpu_torch.ops import resize as PR

    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (2, 37, 50, 3), dtype=np.uint8)
    want = np.asarray(JR.clip_preprocess(jnp.asarray(img), 24, crop=crop))
    got = PR.clip_preprocess(torch.from_numpy(img), 24, crop=crop)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(PR.resize_matrix(50, 24),
                                  JR.resize_matrix(50, 24))
    f = rng.random((3, 20, 9, 2), dtype=np.float32)
    np.testing.assert_allclose(
        PR.resize_bicubic(torch.from_numpy(f), 7, 13).numpy(),
        np.asarray(JR.resize_bicubic(jnp.asarray(f), 7, 13)), rtol=1e-5,
        atol=1e-6)


def test_style_helpers_match_jax():
    """``gram_matrix`` and ``normalize_batch`` at rtol 1e-6 (the port in
    NCHW, JAX in NHWC); ``ReplayBuffer`` bit for bit over a sequence that
    fills it and then swaps."""
    from art_sbir_tpu.ops import style_misc as JS
    from art_sbir_tpu_torch.ops import style_misc as PS

    rng = np.random.default_rng(3)
    feat = rng.normal(size=(2, 6, 5, 8)).astype(np.float32)
    np.testing.assert_allclose(PS.gram_matrix(nchw(feat)).numpy(),
                               np.asarray(JS.gram_matrix(jnp.asarray(feat))),
                               rtol=1e-6, atol=1e-7)
    img = rng.random((2, 4, 4, 3), dtype=np.float32)
    np.testing.assert_allclose(
        PS.normalize_batch(nchw(img)).numpy(),
        np.asarray(JS.normalize_batch(jnp.asarray(img))).transpose(0, 3, 1, 2),
        rtol=1e-6)
    jb, pb = JS.ReplayBuffer(max_size=5, seed=7), PS.ReplayBuffer(5, seed=7)
    for _ in range(6):
        batch = rng.normal(size=(3, 2, 2)).astype(np.float32)
        np.testing.assert_array_equal(
            pb.push_and_pop(torch.from_numpy(batch)).numpy(),
            np.asarray(jb.push_and_pop(jnp.asarray(batch))))


def test_schedules_match_jax():
    """Each schedule equals JAX's float32 value over steps 0..120 (7 a
    epoch); the cosine within rtol 1e-6 (a few float32 ulps: numpy's and
    XLA's float32 ``cos`` differ in the last bit, and ``1 + cos`` cancels
    up to 2.5x of it at these steps); the plateau rule equal step by
    step; ``LambdaLR`` over a schedule gives its rates."""
    from art_sbir_tpu.train import schedules as JS
    from art_sbir_tpu_torch.train import schedules as PS

    pairs = [(PS.linear_decay(2e-4, 5, 8, 7), JS.linear_decay(2e-4, 5, 8, 7)),
             (PS.step_decay(1e-3, 3, 0.5, 7), JS.step_decay(1e-3, 3, 0.5, 7))]
    for step in range(121):
        for port, ref in pairs:
            assert port(step) == float(ref(step)), step
        want = np.float32(JS.cosine_decay(1e-3, 12, 7, 1e-5)(step))
        got = np.float32(PS.cosine_decay(1e-3, 12, 7, 1e-5)(step))
        assert abs(got - want) <= 1e-6 * want, step
    jp, pp = JS.ReduceOnPlateau(0.1, patience=2), PS.ReduceOnPlateau(
        0.1, patience=2)
    for metric in (5.0, 4.0, 4.0, 3.99, 4.1, 4.2, 1.0, 1.0, 1.0, 1.0):
        assert pp.update(metric) == jp.update(metric)

    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=2e-4)
    sched = PS.linear_decay(2e-4, 1, 2)
    lr = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: sched(s) / 2e-4)
    for step in range(4):
        assert opt.param_groups[0]["lr"] == pytest.approx(sched(step))
        opt.step()
        lr.step()


def test_rng_stream():
    """Name ids are JAX's FNV-1a bit for bit; the generator of (name,
    step) does not depend on the order of calls; names and steps give
    other streams."""
    from art_sbir_tpu.core.prng import RngStream as JaxStream
    from art_sbir_tpu_torch.core.prng import RngStream

    names = ["dropout", "augment", "noise", "", "é-ü", "a" * 40]
    j, p = JaxStream(0), RngStream(0)
    assert [p._name_id(n) for n in names] == [j._name_id(n) for n in names]

    def draw(g):
        return torch.rand(4, generator=g)

    a = RngStream(5)
    assert a.key("noise").device == torch.device("cpu")
    first = draw(a.key("noise", 3))
    b = RngStream(5)
    for n in reversed(names):
        draw(b.key(n, 1))
    assert torch.equal(draw(b.key("noise", 3)), first)
    it = RngStream(5).keys("noise", start=2)
    next(it)
    assert torch.equal(draw(next(it)), first)
    others = [draw(a.key("noise", 4)), draw(a.key("augment", 3)),
              draw(RngStream(6).key("noise", 3))]
    assert all(not torch.equal(o, first) for o in others)
    assert random.Random(0).random() == random.Random(0).random()


def test_utils_reexports_the_port():
    from art_sbir_tpu_torch import utils
    from art_sbir_tpu_torch.core import checkpoint
    from art_sbir_tpu_torch.ops import distance

    for name in utils.__all__:
        obj = getattr(utils, name)
        assert getattr(obj, "__module__", "art_sbir_tpu_torch").startswith(
            "art_sbir_tpu_torch"), name
    assert utils.load_state_dict is checkpoint.load_state_dict
    assert utils.euclidean_distance is distance.euclidean_distance
