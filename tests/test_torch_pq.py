"""The port's IVF-PQ (``art_sbir_tpu_torch/ops/pq.py``) against the JAX
package's (``art_sbir_tpu/ops/pq.py``), on the CPU.

As in ``tests/test_torch_ivf.py``, builds are held by their steps and
their quality (the random streams differ) and searches on one shared
index and codebook, built by JAX and written with its ``save_ivf`` /
``save_pq``. To make the ADC tables the same function in both packages
(the port rounds the euclidean table's operands to bf16, JAX on the CPU
does not), the shared IVF centroids, codebook and queries are put on a
grid of sixteenths in [-4, 4] (cosine queries: unit vectors of sixteen
entries of +-1/4, whose normalization is exact) and an OPQ rotation is
replaced by a signed permutation: every table entry and every ADC sum is
then exact in float32 in either package. Tolerances:

* ``_pq_score`` from fed codes and tables: bit for bit (the port sums in
  subspace order, as JAX's scan does).
* ``_adc_lut``: euclidean bit for bit on grid operands; cosine (float32
  dots of normalized queries in another order) at rtol 1e-6.
* ``encode_pq`` / ``pq_decode`` from a fed codebook: equal.
* ``ivf_pq_search`` on the shared index: indices equal; pure-PQ values at
  rtol 1e-6, reranked (exact row-wise) values at rtol 1e-5.
* sharded: the port on ``[cpu] * 8`` against JAX's 8 virtual CPU devices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.ops import ivf as JI
from art_sbir_tpu.ops import pq as JP
from art_sbir_tpu.parallel import mesh as jax_mesh
from art_sbir_tpu_torch.ops import ivf as TI
from art_sbir_tpu_torch.ops import pq as TP
from art_sbir_tpu_torch.ops.distance import (cosine_distance,
                                             euclidean_distance, retrieve)
from art_sbir_tpu_torch.ops.quant import topk_overlap
from art_sbir_tpu_torch.parallel import mesh as port_mesh
from tests.torch_threads import two_torch_threads  # noqa: F401


CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _grid(x) -> np.ndarray:
    """``x`` on the grid of sixteenths in [-4, 4]: products and sums of a
    few of them are exact in float32 (and in bf16's operands)."""
    return (np.clip(np.round(np.asarray(x, np.float32) * 16), -64, 64)
            / 16).astype(np.float32)


def _signed_permutation(d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    r = np.zeros((d, d), np.float32)
    r[np.arange(d), rng.permutation(d)] = rng.choice([-1.0, 1.0], d)
    return r


def _exact(q, g, k, metric="euclidean"):
    """The exact route's indices and their row-wise distances."""
    q, g = _t(q), _t(g)
    _, _, ei = retrieve(q, g, torch.zeros(len(q), dtype=torch.int32), k=k,
                        metric=metric)
    row = euclidean_distance if metric == "euclidean" else cosine_distance
    return row(q[:, None], g[ei.long()]), ei


def _same(got, want, rtol):
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=rtol, atol=1e-6)


def _data(seed=2, n=160, d=32):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((6, d)) * 2.0
    g = (centers[rng.integers(0, 6, n)]
         + 0.5 * rng.standard_normal((n, d))).astype(np.float32)
    return g, rng


def _queries(metric, rng, g, nq=8):
    """Grid queries near gallery rows; for cosine, unit vectors of 16
    entries +-1/4 (their normalization is exact, so are their tables)."""
    d = g.shape[1]
    if metric == "euclidean":
        return _grid(g[rng.integers(0, len(g), nq)]
                     + 0.1 * rng.standard_normal((nq, d)))
    q = np.zeros((nq, d), np.float32)
    for row in q:
        at = rng.choice(d, 16, replace=False)
        row[at] = rng.choice([-0.25, 0.25], 16)
    return q


@functools.lru_cache(maxsize=None)
def _shared_build(metric: str, form: str):
    """JAX's IVF + PQ over ``_data()`` put on the grid: (ji, jcb, jcodes)
    with ``form`` raw (``train_pq`` + ``encode_pq``), residual
    (``build_ivf_pq``) or opq (residual with a rotation)."""
    g, _ = _data()
    ji = JI.build_ivf(jnp.asarray(g), 6, metric=metric, iters=5)
    ji = ji._replace(centroids=jnp.asarray(_grid(ji.centroids)))
    if form == "raw":
        jcb = JP.train_pq(jnp.asarray(g), 8, k_codes=16, metric=metric,
                          iters=5)
        jcodes = JP.encode_pq(jnp.asarray(g), jcb)
    else:
        jcb, jcodes = JP.build_ivf_pq(jnp.asarray(g), ji, 8, k_codes=16,
                                      iters=5,
                                      opq_iters=2 if form == "opq" else 0)
    rot = (jnp.asarray(_signed_permutation(32, 3))
           if jcb.rotation is not None else None)
    jcb = jcb._replace(centroids=jnp.asarray(_grid(jcb.centroids)),
                       rotation=rot)
    return ji, jcb, jcodes


def _shared(tmp_path, metric, form):
    """(JAX triple, port triple) of one shared index: JAX's files, read by
    the port."""
    ji, jcb, jcodes = _shared_build(metric, form)
    JI.save_ivf(ji, tmp_path / "ivf.npz")
    JP.save_pq(jcb, jcodes, tmp_path / "pq.npz")
    ti = TI.load_ivf(tmp_path / "ivf.npz", device="cpu")
    tcb, tcodes = TP.load_pq(tmp_path / "pq.npz", device="cpu")
    return (ji, jcb, jcodes), (ti, tcb, tcodes)


# ------------------------------------------------------------ codebooks

def _planted(rng, n, m, ds, per_sub=4, noise=0.01):
    """Rows whose m-th subspace is one of ``per_sub`` planted vectors."""
    vocab = rng.standard_normal((m, per_sub, ds)).astype(np.float32) * 3.0
    pick = rng.integers(0, per_sub, (n, m))
    rows = np.concatenate([vocab[j, pick[:, j]] for j in range(m)], axis=1)
    rows = rows + noise * rng.standard_normal(rows.shape)
    return rows.astype(np.float32), vocab


@pytest.mark.parametrize("rotated", [False, True])
def test_encode_and_decode_from_fed_codebook_match_jax(rotated):
    rng = np.random.default_rng(0)
    m, ds = 4, 8
    rows, vocab = _planted(rng, 256, m, ds)
    cent = _grid(vocab)
    rot = _signed_permutation(m * ds, 1) if rotated else None
    if rotated:  # the planted structure lives in the rotated space
        rows = rows @ rot.T
    jcb = JP.PQCodebook(jnp.asarray(cent), "euclidean", False,
                        None if rot is None else jnp.asarray(rot))
    tcb = TP.PQCodebook(_t(cent), "euclidean", False,
                        None if rot is None else _t(rot))
    want = np.asarray(JP.encode_pq(jnp.asarray(rows), jcb, chunk=100))
    got = TP.encode_pq(_t(rows), tcb, chunk=100)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TP.pq_decode(got, tcb).numpy(),
        np.asarray(JP.pq_decode(jnp.asarray(want), jcb)))
    assert TP._split(_t(rows), m).shape == (m, 256, ds)
    np.testing.assert_array_equal(TP._split(_t(rows), m).numpy(),
                                  np.asarray(JP._split(jnp.asarray(rows), m)))


def test_train_pq_recovers_planted_subspaces():
    """tests/test_ops_pq.py's contract for the port's training: every
    planted subspace vector has a centroid within the noise, and the
    reconstruction error shrinks as the codebook grows."""
    rng = np.random.default_rng(0)
    m, ds = 4, 8
    rows, vocab = _planted(rng, 512, m, ds)
    cb = TP.train_pq(_t(rows), m, k_codes=4, iters=15, seed=1)
    cent = cb.centroids.numpy()
    for j in range(m):
        d = np.linalg.norm(vocab[j][:, None] - cent[j][None], axis=-1)
        assert d.min(axis=1).max() < 0.1, (j, d.min(axis=1))
    rec = TP.pq_decode(TP.encode_pq(_t(rows), cb), cb).numpy()
    err = np.linalg.norm(rec - rows, axis=1) / np.linalg.norm(rows, axis=1)
    assert err.max() < 0.02
    x = rng.standard_normal((1024, 32)).astype(np.float32)
    errs = []
    for k_codes in (4, 16, 64):
        cb = TP.train_pq(_t(x), 4, k_codes=k_codes, iters=8)
        rec = TP.pq_decode(TP.encode_pq(_t(x), cb), cb).numpy()
        errs.append(float(np.mean(np.sum((rec - x) ** 2, axis=1))))
    assert errs[0] > errs[1] > errs[2], errs


def test_opq_rotation_orthogonal_and_cuts_correlated_error():
    rng = np.random.default_rng(14)
    d, m, n = 32, 8, 2048
    mix = rng.standard_normal((8, d)).astype(np.float32)
    x = (rng.standard_normal((n, 8)).astype(np.float32) @ mix
         + 0.05 * rng.standard_normal((n, d))).astype(np.float32)
    pq = TP.train_pq(_t(x), m, k_codes=16, iters=8)
    opq = TP.train_pq(_t(x), m, k_codes=16, iters=8, opq_iters=5)
    r = opq.rotation.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(d), atol=1e-4)

    def mse(cb):
        rec = TP.pq_decode(TP.encode_pq(_t(x), cb), cb).numpy()
        return float(np.mean(np.sum((rec - x) ** 2, axis=1)))

    assert mse(opq) < 0.9 * mse(pq), (mse(opq), mse(pq))


# ------------------------------------------------------------------- ADC

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_adc_lut_matches_jax(metric):
    rng = np.random.default_rng(3)
    cent = _grid(rng.standard_normal((8, 16, 4)))
    q = _grid(rng.standard_normal((5, 32)))
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    want = np.asarray(JP._adc_lut(jnp.asarray(q),
                                  JP.PQCodebook(jnp.asarray(cent), metric)))
    got = TP._adc_lut(_t(q), TP.PQCodebook(_t(cent), metric)).numpy()
    assert got.shape == (5, 8, 16)
    if metric == "euclidean":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_pq_score_matches_jax_bit_for_bit():
    """Fed codes and tables: the gather-and-ordered-sum equals the
    one-hot scan exactly, on arbitrary float32 tables."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 256, (3, 37, 64)).astype(np.uint8)
    lut = rng.standard_normal((3, 64, 256)).astype(np.float32) * 10.0
    want = np.asarray(JP._pq_score(jnp.asarray(codes), jnp.asarray(lut)))
    got = TP._pq_score(_t(codes), _t(lut)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("form", ["raw", "residual", "opq"])
def test_ivf_pq_search_matches_jax_on_shared_index(tmp_path, metric, form):
    (ji, jcb, jcodes), (ti, tcb, tcodes) = _shared(tmp_path, metric, form)
    g, rng = _data()
    q = _queries(metric, rng, g)
    assert tcb.residual == (form != "raw") and tcb.metric == metric
    assert (tcb.rotation is not None) == (form == "opq")
    for nprobe in (2, 6):
        for rows, rtol in ((None, 1e-6), ("f32", 1e-5), ("bf16", 1e-5)):
            jrows = trows = None
            if rows is not None:
                jrows, trows = jnp.asarray(g), _t(g)
                if rows == "bf16":
                    jrows, trows = jrows.astype(jnp.bfloat16), trows.bfloat16()
            want = JP.ivf_pq_search(jnp.asarray(q), ji, jcodes, jcb,
                                    nprobe=nprobe, k=7, rows=jrows,
                                    rerank_factor=2)
            got = TP.ivf_pq_search(_t(q), ti, tcodes, tcb, nprobe=nprobe,
                                   k=7, rows=trows, rerank_factor=2)
            _same(got, want, rtol)
    # query chunks (a budget of one query) change nothing
    _same(TP.ivf_pq_search(_t(q), ti, tcodes, tcb, nprobe=3, k=5,
                           row_budget_bytes=1),
          TP.ivf_pq_search(_t(q), ti, tcodes, tcb, nprobe=3, k=5), 0)


# ----------------------------------------------------------------- builds

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("form", ["raw", "residual", "opq"])
def test_full_probe_full_rerank_equals_exact_route(metric, form):
    """The port's own builds: full probe with a rerank covering every
    candidate equals the exact route, duplicates' order included."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal((150, 32)).astype(np.float32)
    g = np.concatenate([g, g[:9]])
    q = rng.standard_normal((8, 32)).astype(np.float32)
    idx = TI.build_ivf(_t(g), 6, metric=metric, iters=5)
    if form == "raw":
        cb = TP.train_pq(_t(g), 8, k_codes=16, metric=metric, iters=5)
        codes = TP.encode_pq(_t(g), cb)
    else:
        cb, codes = TP.build_ivf_pq(_t(g), idx, 8, k_codes=16, iters=5,
                                    opq_iters=3 if form == "opq" else 0)
        assert cb.residual and cb.metric == metric
    got = TP.ivf_pq_search(_t(q), idx, codes, cb, nprobe=idx.nlist, k=7,
                           rows=_t(g), rerank_factor=1000)
    _same(got, _exact(q, g, 7, metric), 1e-5)


def test_pure_pq_self_retrieval_and_units():
    rng = np.random.default_rng(3)
    g = (10.0 * rng.standard_normal((64, 16))).astype(np.float32)
    for metric in ("euclidean", "cosine"):
        idx = TI.build_ivf(_t(g), 4, metric=metric, iters=8)
        cb = TP.train_pq(_t(g), 4, k_codes=64, metric=metric, iters=10)
        vals, ids = TP.ivf_pq_search(_t(g), idx, TP.encode_pq(_t(g), cb), cb,
                                     nprobe=idx.nlist, k=3)
        assert (ids.numpy()[:, 0] == np.arange(64)).all()
        v = vals.numpy()
        if metric == "euclidean":
            assert (v[:, 0] >= 0).all() and (v[:, 0] < 0.5 * v[:, 1]).all()
        else:
            assert (v >= -1e-5).all() and (v <= 2.0 + 1e-5).all()


def test_residual_beats_raw_pq_on_many_blobs():
    """tests/test_ops_pq.py's miniature of raw PQ's collapse on clustered
    rows: residual codes rank within a cluster, raw ones cannot."""
    rng = np.random.default_rng(8)
    d, n_blobs, per = 64, 64, 16
    centers = 6.0 * rng.standard_normal((n_blobs, d)).astype(np.float32)
    g = (np.repeat(centers, per, axis=0)
         + 0.5 * rng.standard_normal((n_blobs * per, d))).astype(np.float32)
    q = g[rng.integers(0, len(g), 32)] + 0.1 * rng.standard_normal(
        (32, d)).astype(np.float32)
    idx = TI.build_ivf(_t(g), n_blobs, iters=10)
    _, exact = _exact(q, g, 10)
    raw_cb = TP.train_pq(_t(g), 8, k_codes=64, iters=8)
    _, raw_ids = TP.ivf_pq_search(_t(q), idx, TP.encode_pq(_t(g), raw_cb),
                                  raw_cb, nprobe=4, k=10)
    cb, codes = TP.build_ivf_pq(_t(g), idx, 8, k_codes=64, iters=8)
    _, res_ids = TP.ivf_pq_search(_t(q), idx, codes, cb, nprobe=4, k=10)
    raw, res = topk_overlap(raw_ids, exact), topk_overlap(res_ids, exact)
    assert res > raw + 0.15 and res > 0.8, (raw, res)
    _, self_ids = TP.ivf_pq_search(_t(g[:16]), idx, codes, cb, nprobe=1, k=1)
    assert (self_ids.numpy()[:, 0] == np.arange(16)).all()


def test_chunked_build_equals_one_shot_and_empty_batch():
    rng = np.random.default_rng(9)
    g = rng.standard_normal((100, 16)).astype(np.float32)
    idx = TI.build_ivf(_t(g), 4, iters=5)
    cb1, c1 = TP.build_ivf_pq(_t(g), idx, 4, k_codes=16, iters=5,
                              chunk=16384)
    cb2, c2 = TP.build_ivf_pq(_t(g), idx, 4, k_codes=16, iters=5, chunk=16)
    assert torch.equal(cb1.centroids, cb2.centroids)
    assert torch.equal(c1, c2)
    v, i = TP.ivf_pq_search(torch.zeros((0, 16)), idx, c1, cb1, nprobe=3,
                            k=5)
    assert v.shape == (0, 5) and i.shape == (0, 5)


def test_validation_matches_jax():
    rng = np.random.default_rng(6)
    g = rng.standard_normal((64, 16)).astype(np.float32)
    for P, arr in ((JP, jnp.asarray(g)), (TP, _t(g))):
        with pytest.raises(ValueError, match="divisible"):
            P.train_pq(arr, 5)
        with pytest.raises(ValueError, match="k_codes"):
            P.train_pq(arr, 4, k_codes=300)
        with pytest.raises(ValueError, match="metric"):
            P.train_pq(arr, 4, metric="dot")
        with pytest.raises(ValueError, match="rows to train"):
            P.train_pq(arr[:8], 4, k_codes=16)
    cb = TP.train_pq(_t(g), 4, k_codes=8, iters=3)
    with pytest.raises(ValueError, match="dim"):
        TP.encode_pq(_t(g[:, :8]), cb)
    idx = TI.build_ivf(_t(g), 4, iters=3)
    codes = TP.encode_pq(_t(g), cb)
    with pytest.raises(ValueError, match="nprobe"):
        TP.ivf_pq_search(_t(g[:2]), idx, codes, cb, nprobe=0)
    with pytest.raises(ValueError, match="rerank_factor"):
        TP.ivf_pq_search(_t(g[:2]), idx, codes, cb, nprobe=1, rows=_t(g),
                         rerank_factor=0)
    cidx = TI.build_ivf(_t(g), 4, metric="cosine", iters=3)
    with pytest.raises(ValueError, match="metric"):
        TP.ivf_pq_search(_t(g[:2]), cidx, codes, cb, nprobe=1)


# --------------------------------------------------------------- sharded

def _pmesh(n=8):
    return port_mesh.MeshSpec(n).build([CPU] * n)


def _jmesh():
    return jax_mesh.MeshSpec(data=len(jax.devices())).build()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_sharded_pq_matches_jax_on_shared_index(tmp_path, metric):
    """JAX's sharded IVF and shared codebook (grid, files) read by the
    port onto ``[cpu] * 8``: pure and reranked searches against JAX's at
    nprobe 1 and full probe; full probe with a covering rerank equals the
    exact route, cross-shard duplicates included."""
    rng = np.random.default_rng(21)
    g = rng.standard_normal((200 - 8, 32)).astype(np.float32)
    g = np.concatenate([g, g[:8]])
    q = _queries(metric, rng, g, 6)
    js = JI.build_ivf_sharded(jnp.asarray(g), 8, 4, metric=metric, iters=4)
    js = js._replace(centroids=jnp.asarray(_grid(js.centroids)))
    jcb, jcodes = JP.build_ivf_pq_sharded(jnp.asarray(g), js, 8, k_codes=16,
                                          iters=4)
    jcb = jcb._replace(centroids=jnp.asarray(_grid(jcb.centroids)))
    JI.save_ivf_sharded(js, tmp_path / "ivf_sharded.npz")
    JP.save_pq(jcb, jcodes, tmp_path / "pq_sharded.npz")
    ts = TI.load_ivf_sharded(tmp_path / "ivf_sharded.npz", devices="cpu")
    tcb, tcodes = TP.load_pq(tmp_path / "pq_sharded.npz", device="cpu")
    for nprobe in (1, 4):
        for rows, rtol in ((None, 1e-6), (True, 1e-5)):
            want = JP.ivf_pq_search_sharded(
                jnp.asarray(q), js, jcodes, jcb, _jmesh(), nprobe=nprobe,
                k=5, rows=None if rows is None else jnp.asarray(g),
                rerank_factor=3)
            got = TP.ivf_pq_search_sharded(
                _t(q), ts, tcodes, tcb, _pmesh(), nprobe=nprobe, k=5,
                rows=None if rows is None else _t(g), rerank_factor=3)
            _same(got, want, rtol)
    got = TP.ivf_pq_search_sharded(_t(q), ts, tcodes, tcb, _pmesh(),
                                   nprobe=4, k=7, rows=_t(g),
                                   rerank_factor=1000)
    _same(got, _exact(q, g, 7, metric), 1e-5)


def test_sharded_pq_build_and_guards():
    """The port's own sharded build: full probe and covering rerank equal
    the exact route; pure mode self-retrieves; query chunks change
    nothing; JAX's guards."""
    rng = np.random.default_rng(22)
    g = (10.0 * rng.standard_normal((16 * 8, 16))).astype(np.float32)
    ts = TI.build_ivf_sharded(_t(g), 8, 4, iters=8)
    cb, codes = TP.build_ivf_pq_sharded(_t(g), ts, 4, k_codes=64, iters=10)
    assert cb.residual and codes.shape == (128, 4)
    assert codes.dtype == torch.uint8
    got = TP.ivf_pq_search_sharded(_t(g[:5] + 1.0), ts, codes, cb, _pmesh(),
                                   nprobe=4, k=7, rows=_t(g),
                                   rerank_factor=1000)
    _same(got, _exact(g[:5] + 1.0, g, 7), 1e-5)
    vals, ids = TP.ivf_pq_search_sharded(_t(g), ts, codes, cb, _pmesh(),
                                         nprobe=4, k=3)
    assert (ids.numpy()[:, 0] == np.arange(128)).all()
    v = vals.numpy()
    assert (v[:, 0] < 0.5 * v[:, 1]).all()
    cv, ci = TP.ivf_pq_search_sharded(_t(g), ts, codes, cb, _pmesh(),
                                      nprobe=4, k=3, row_budget_bytes=1 << 14)
    assert torch.equal(ci, ids) and torch.equal(cv, vals)
    flat = TI.build_ivf(_t(g), 2, iters=3)
    with pytest.raises(ValueError, match="ShardedIVF"):
        TP.build_ivf_pq_sharded(_t(g), flat, 4)
    with pytest.raises(ValueError, match="ShardedIVF"):
        TP.ivf_pq_search_sharded(_t(g[:2]), flat, codes, cb, _pmesh())
    with pytest.raises(ValueError, match="nprobe"):
        TP.ivf_pq_search_sharded(_t(g[:2]), ts, codes, cb, _pmesh(),
                                 nprobe=0)
    with pytest.raises(ValueError, match="exceeds the per-shard"):
        TP.ivf_pq_search_sharded(_t(g[:2]), ts, codes, cb, _pmesh(), k=17)
    with pytest.raises(ValueError, match="codes rows"):
        TP.ivf_pq_search_sharded(_t(g[:2]), ts, codes[:-1], cb, _pmesh())
    with pytest.raises(ValueError, match="shard like the codes"):
        TP.ivf_pq_search_sharded(_t(g[:2]), ts, codes, cb, _pmesh(),
                                 rows=_t(g[:-1]))
    ccb = TP.PQCodebook(cb.centroids, "cosine", True, None)
    with pytest.raises(ValueError, match="metric"):
        TP.ivf_pq_search_sharded(_t(g[:2]), ts, codes, ccb, _pmesh())


# ------------------------------------------------------------------ files

@pytest.mark.parametrize("rotated", [False, True])
def test_pq_files_round_trip_both_directions(tmp_path, rotated):
    rng = np.random.default_rng(16)
    g = rng.standard_normal((100, 16)).astype(np.float32)
    ji = JI.build_ivf(jnp.asarray(g), 4, iters=4)
    jcb, jcodes = JP.build_ivf_pq(jnp.asarray(g), ji, 4, k_codes=16, iters=4,
                                  opq_iters=2 if rotated else 0)
    JP.save_pq(jcb, jcodes, tmp_path / "j.npz")
    tcb, tcodes = TP.load_pq(tmp_path / "j.npz", device="cpu")
    TP.save_pq(tcb, tcodes, tmp_path / "t.npz")
    bcb, bcodes = JP.load_pq(tmp_path / "t.npz")
    for cb, codes in ((tcb, tcodes), (bcb, bcodes)):
        np.testing.assert_array_equal(np.asarray(codes), np.asarray(jcodes))
        np.testing.assert_array_equal(np.asarray(cb.centroids),
                                      np.asarray(jcb.centroids))
        assert (cb.metric, cb.residual) == (jcb.metric, jcb.residual)
        assert (cb.rotation is None) == (not rotated)
        if rotated:
            np.testing.assert_array_equal(np.asarray(cb.rotation),
                                          np.asarray(jcb.rotation))
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert all(zj[k].dtype == zt[k].dtype for k in zj.files)


@pytest.mark.cuda
def test_cuda_adc_gather_equals_per_subspace_loop():
    """On the card: the one-gather ADC score equals the plain loop that
    adds ``LUT[q, m, code]`` one subspace at a time, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    codes = torch.randint(0, 256, (8, 5000, 64), generator=gen,
                          device="cuda", dtype=torch.uint8)
    lut = torch.randn((8, 64, 256), generator=gen, device="cuda")
    want = torch.zeros((8, 5000), device="cuda")
    for m in range(64):
        want = want + torch.gather(lut[:, m], 1, codes[:, :, m].long())
    assert torch.equal(TP._pq_score(codes, lut), want)
