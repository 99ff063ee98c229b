"""The port's augmentations and triplet-batch finishing against the JAX
package's, on the CPU.

* The warps and the matrix builders at fed parameters (the same angles,
  shifts, scales, shears, corner points and matrices on both sides):
  equal within 1e-5 (pixels in [0, 1]; matrices scaled to their largest
  entry).
* ``finish_triplet_batch`` on its deterministic branches (no augmentation;
  the augment branch with every sample masked off): equal within 1e-6.
* The draws, held by distribution as the JAX package's own tests hold
  its (``tests/test_ops_augment.py``): the same numpy oracles of
  torchvision's samplers, the same KS bounds.
* The paired flip: one coin for sketch and positive, another for the
  negative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as st

from art_sbir_tpu.ops import augment as JA
from art_sbir_tpu.train.prepare import finish_triplet_batch as jax_finish
from art_sbir_tpu_torch.ops import augment as PA
from art_sbir_tpu_torch.train.prepare import finish_triplet_batch
from tests.test_ops_augment import _N, _erase_oracle
from tests.torch_threads import two_torch_threads  # noqa: F401


S = 32


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _images(rng, b=3, s=S):
    x = rng.random((b, s, s, 3)).astype(np.float32)
    x[:, s // 4:3 * s // 4, s // 3, :] = 0.0  # a dark stroke
    return x


def _affine_inputs(rng, b):
    f = lambda lo, hi: rng.uniform(lo, hi, b).astype(np.float32)  # noqa: E731
    return (f(-30, 30), (np.round(f(-4, 4)), np.round(f(-4, 4))), f(0.8, 1.3),
            (f(-10, 10), f(-10, 10)))


def _jax_affine(angle, tr, sc, sh, center):
    return jax.vmap(lambda a, tx, ty, s, sx, sy: JA.affine_inverse_matrix(
        a, (tx, ty), s, (sx, sy), center))(angle, *tr, sc, *sh)


def test_affine_matrix_matches_jax():
    rng = np.random.default_rng(0)
    angle, tr, sc, sh = _affine_inputs(rng, 16)
    center = ((S - 1) * 0.5, (S - 1) * 0.5)
    want = np.asarray(_jax_affine(angle, tr, sc, sh, center))
    t = torch.from_numpy
    got = PA.affine_inverse_matrix(t(angle), (t(tr[0]), t(tr[1])), t(sc),
                                   (t(sh[0]), t(sh[1])), center).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_homography_matches_jax():
    rng = np.random.default_rng(1)
    b = 16
    start = np.array([[0, 0], [S - 1, 0], [S - 1, S - 1], [0, S - 1]],
                     np.float32)
    end = (start + rng.integers(-5, 6, (b, 4, 2))).astype(np.float32)
    want = np.asarray(jax.vmap(lambda e: JA.homography_from_points(
        e, jnp.asarray(start)))(jnp.asarray(end)))
    got = PA.homography_from_points(
        torch.from_numpy(end),
        torch.from_numpy(start).expand(b, 4, 2)).numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)
    # and it maps the corners
    pts = np.concatenate([end, np.ones((b, 4, 1), np.float32)], -1)
    mapped = np.einsum("bij,bkj->bki", got, pts)
    np.testing.assert_allclose(mapped[..., :2] / mapped[..., 2:],
                               np.broadcast_to(start, (b, 4, 2)), atol=1e-3)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_warp_matches_jax_at_fed_matrices(method):
    """The same matrices (a projective one and an affine one an image)
    give the same pixels, white where a tap leaves the image."""
    rng = np.random.default_rng(2)
    x = _images(rng)
    b = len(x)
    proj = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    proj[:, :2] += 0.05 * rng.standard_normal((b, 2, 3)).astype(np.float32)
    proj[:, :2, 2] += 2.0 * rng.standard_normal((b, 2)).astype(np.float32)
    proj[:, 2, :2] = 1e-3 * rng.standard_normal((b, 2)).astype(np.float32)
    center = ((S - 1) * 0.5, (S - 1) * 0.5)
    aff = np.asarray(_jax_affine(*_affine_inputs(rng, b), center))
    for m in (proj, aff):
        want = np.asarray(jax.vmap(lambda im, h: JA.warp_projective(
            im, h, method, fill=1.0))(jnp.asarray(x), jnp.asarray(m)))
        got = PA.warp_projective(torch.from_numpy(x), torch.from_numpy(m),
                                 method, fill=1.0).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert (got == 1.0).any()  # some taps fell outside: white


def test_warp_identity_preserves_image():
    x = torch.from_numpy(_images(np.random.default_rng(3)))
    eye = torch.eye(3).expand(len(x), 3, 3)
    assert torch.equal(PA.warp_projective(x, eye, "nearest"), x)
    torch.testing.assert_close(PA.warp_projective(x, eye, "bilinear"), x,
                               atol=1e-5, rtol=0)


# ------------------------------------------------------ finish_triplet_batch


def _u8_batch(rng, b=4, s=S, mask=None):
    out = {k: rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
           for k in ("sketch", "positive", "negative")}
    out["label"] = rng.integers(0, 5, b).astype(np.int32)
    if mask is not None:
        out["augment"] = np.asarray(mask, np.int32)
    return out


@pytest.mark.parametrize("train,version,flip", [(False, 1, True),
                                                (True, 0, False)])
def test_finish_without_augmentation_matches_jax(train, version, flip):
    batch = _u8_batch(np.random.default_rng(4))
    want = jax_finish({k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.key(0), augment_version=version, flip=flip,
                      train=train)
    got = finish_triplet_batch({k: torch.from_numpy(v)
                                for k, v in batch.items()}, _gen(),
                               augment_version=version, flip=flip,
                               train=train)
    assert set(got) == set(want)
    for k in ("sketch", "positive", "negative"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)
    np.testing.assert_array_equal(got["label"].numpy(), batch["label"])


def test_finish_mask_keeps_unmasked_samples_plain():
    """The Mixed catalogs' per-sample mask: masked-off samples come out as
    the plain branch gives them, on both sides; masked-on ones change."""
    rng = np.random.default_rng(5)
    batch = _u8_batch(rng, b=6, mask=[0, 1, 0, 1, 1, 0])
    batch["sketch"][:] = 255
    batch["sketch"][:, 8:24, 8:24] = 0  # a box: any warp or erase moves it
    plain = jax_finish({k: jnp.asarray(v) for k, v in batch.items()},
                       train=False)
    want = jax_finish({k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.key(1), augment_version=1, flip=True)
    changed = []
    for seed in range(4):
        got = finish_triplet_batch({k: torch.from_numpy(v)
                                    for k, v in batch.items()}, _gen(seed),
                                   augment_version=1, flip=True)
        for k in ("sketch", "positive", "negative"):
            for i in (0, 2, 5):
                np.testing.assert_allclose(got[k][i].numpy(),
                                           np.asarray(plain[k][i]), atol=1e-6)
                np.testing.assert_allclose(np.asarray(want[k][i]),
                                           np.asarray(plain[k][i]), atol=1e-6)
        changed += [not np.allclose(got["sketch"][i].numpy(),
                                    np.asarray(plain["sketch"][i]))
                    for i in (1, 3, 4)]
    assert any(changed)


# ------------------------------------------------------------- the draws


def test_perspective_endpoint_distribution():
    """Each corner displacement is discrete-uniform on {0..int(d*half)}."""
    h = w = 64
    d = 0.3
    dmaxes = [int(d * (w // 2)), int(d * (h // 2))] * 4
    start, end = PA.perspective_endpoints(_gen(0), _N, h, w, d)
    np.testing.assert_array_equal(
        start.numpy(), [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]])
    end = end.numpy()
    disp = np.stack([end[:, 0, 0], end[:, 0, 1],
                     (w - 1) - end[:, 1, 0], end[:, 1, 1],
                     (w - 1) - end[:, 2, 0], (h - 1) - end[:, 2, 1],
                     end[:, 3, 0], (h - 1) - end[:, 3, 1]])
    for row, dmax in zip(disp, dmaxes):
        vals = row.astype(int)
        assert vals.min() >= 0 and vals.max() <= dmax
        counts = np.bincount(vals, minlength=dmax + 1)
        freq = counts / len(vals)
        sigma = np.sqrt((1 / (dmax + 1)) * (1 - 1 / (dmax + 1)) / len(vals))
        assert (counts > 0).all()
        assert np.abs(freq - 1 / (dmax + 1)).max() < 4.5 * sigma, freq


def test_affine_params_distribution():
    """angle, scale, shear ~ U(ranges); translate = round(U(-max, max))."""
    h = w = 224
    r = PA.AffineRanges(degrees=15.0, translate=0.1, scale=(0.9, 1.1),
                        shear=7.0)
    angle, (tx, ty), scale, (shx, shy) = PA.affine_params(_gen(1), _N, h, w,
                                                          r)
    rng = np.random.default_rng(7)
    checks = [(angle, rng.uniform(-15, 15, _N)),
              (scale, rng.uniform(0.9, 1.1, _N)),
              (shx, rng.uniform(-7, 7, _N)), (shy, rng.uniform(-7, 7, _N)),
              (tx, np.round(rng.uniform(-0.1 * w, 0.1 * w, _N))),
              (ty, np.round(rng.uniform(-0.1 * h, 0.1 * h, _N)))]
    for ours, oracle in checks:
        ks = st.ks_2samp(ours.numpy(), oracle)
        assert ks.statistic < 0.05, ks.statistic
    assert torch.equal(tx, torch.round(tx))


def test_erase_params_distribution():
    """(i, j, eh, ew, found) against the numpy oracle of torchvision's
    10-attempt loop, in an easy and a rejection-heavy regime."""
    for n, (h, w, scale, ratio) in enumerate([
            (224, 224, (0.05, 0.2), (0.3, 3.3)),
            (24, 24, (0.05, 0.2), (0.05, 20.0))]):
        i, j, eh, ew, found = PA.erase_params(_gen(2 + n), _N, h, w, scale,
                                              ratio)
        ours = torch.stack([i, j, eh, ew], 1).double().numpy()
        ok = found.numpy()
        oracle = _erase_oracle(np.random.default_rng(11), h, w, scale, ratio)
        assert abs(ok.mean() - oracle[:, 4].mean()) < 0.03
        for col in range(4):
            ks = st.ks_2samp(ours[ok][:, col],
                             oracle[oracle[:, 4] > 0][:, col])
            assert ks.statistic < 0.06, (h, col, ks.statistic)
        frac = ours[ok][:, 2] * ours[ok][:, 3] / (h * w)
        assert frac.min() > scale[0] * 0.6 and frac.max() < scale[1] * 1.5


def test_erase_writes_white_rectangles():
    img = torch.zeros(8, 64, 64, 3)  # black: the erased box is pure white
    out = PA.apply_erase(img, _gen(3), p=1.0, scale=(0.05, 0.2))
    for im in out[..., 0].numpy():
        white = im == 1.0
        assert 0.04 <= white.mean() <= 0.21, white.mean()
        ys, xs = np.nonzero(white)
        assert white[ys.min():ys.max() + 1, xs.min():xs.max() + 1].all()
    assert torch.equal(PA.apply_erase(img, _gen(3), p=0.0,
                                      scale=(0.05, 0.2)), img)


@pytest.mark.parametrize("version", [1, 2])
def test_sketch_augment_runs_on_a_generator(version):
    """Finite, in [0, 1] before the normalize, the same for the same seed,
    another for another seed."""
    x = torch.ones(8, S, S, 3)
    x[:, 8:24, 8:24] = 0.0
    a1 = PA.sketch_augment(x, _gen(5), version=version, do_normalize=False)
    a2 = PA.sketch_augment(x, _gen(5), version=version, do_normalize=False)
    a3 = PA.sketch_augment(x, _gen(6), version=version, do_normalize=False)
    assert a1.shape == x.shape and torch.isfinite(a1).all()
    assert torch.equal(a1, a2) and not torch.equal(a1, a3)
    assert a1.min() >= 0.0 and a1.max() <= 1.0
    with pytest.raises(ValueError, match="unknown augmentation version"):
        PA.sketch_augment(x, _gen(5), version=3)


def test_paired_hflip_consistency():
    rng = np.random.default_rng(8)
    b = 256
    sk, pos, neg = (torch.from_numpy(rng.random((b, 8, 8, 3))
                                     .astype(np.float32)) for _ in range(3))
    s2, p2, n2 = PA.paired_hflip(_gen(7), sk, pos, neg)
    flipped = lambda a, o: torch.equal(a, torch.flip(o, dims=(1,)))  # noqa
    fs = [flipped(s2[i], sk[i]) for i in range(b)]
    for i in range(b):
        assert fs[i] == flipped(p2[i], pos[i])  # the same coin
        assert fs[i] or torch.equal(s2[i], sk[i])
    fn = [flipped(n2[i], neg[i]) for i in range(b)]
    # two coins of p = 0.5: each near half, and not the same coin
    for f in (fs, fn):
        assert abs(np.mean(f) - 0.5) < 4.5 * np.sqrt(0.25 / b)
    assert fs != fn
