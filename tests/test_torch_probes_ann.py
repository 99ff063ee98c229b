"""The port's IVF and PQ probes (``art_sbir_tpu_torch/scripts/``) against
the JAX package, and run at a tiny size on the CPU.

* ``probe_pq_scoring``: the three ADC forms equal the port's
  ``ops/pq.py::_pq_score`` and JAX's on the same numpy codes and table
  (float32 forms at rtol 1e-6 and atol 1e-5, the bf16 form at JAX's
  rtol 2e-2 and atol 2e-1).
* ``probe_ann_learned``: its distractors equal JAX's
  ``_learnable_photo`` bit for bit, its Gram-form rank JAX's formula
  (``scripts/probe_ann_learned.py:233-240``), its writer leaves no key of
  an older golden, and its stages run end to end with a thin encoder
  (layers (2, 1, 1, 1), width 8, 64 px, one epoch) over 256
  distractors, giving ``goldens/ann_learned_tpu.json``'s fields.
* ``probe_ivf`` and ``probe_pq --part a`` run once each at 2,000 rows
  and print every route.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.data.synthetic import _learnable_photo as jax_photo
from art_sbir_tpu.ops.pq import _pq_score as jax_pq_score
from art_sbir_tpu_torch.ops.pq import _pq_score
from art_sbir_tpu_torch.scripts import probe_ann_learned as ann
from art_sbir_tpu_torch.scripts import probe_ivf, probe_pq
from art_sbir_tpu_torch.scripts import probe_pq_scoring as scoring
from tests.torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("b,c,m", [(3, 40, 8), (2, 17, 64)])
def test_adc_forms_equal_pq_score_and_jax(b, c, m):
    rng = np.random.default_rng(b * 100 + c)
    codes = rng.integers(0, 256, (b, c, m)).astype(np.uint8)
    lut = rng.uniform(0.0, 1.0, (b, m, 256)).astype(np.float32)
    want = np.asarray(jax_pq_score(jnp.asarray(codes), jnp.asarray(lut)))
    ct, lt = torch.from_numpy(codes), torch.from_numpy(lut)
    np.testing.assert_allclose(_pq_score(ct, lt).numpy(), want,
                               **scoring.F32_TOL)
    for name, fn, tol in scoring.FORMS:
        np.testing.assert_allclose(fn(ct, lt).numpy(), want, err_msg=name,
                                   **tol)
    scoring.check_forms(ct, lt)


def test_distractors_equal_jax_learnable_photos():
    start, count, size, per = 197, 6, 64, 200
    got = ann.distractor_loader(start, count, size, per)
    for j in range(count):
        i = start + j
        want = np.asarray(jax_photo(ann.DISTRACTOR_CLASS_BASE + i // per,
                                    i % per, size))
        np.testing.assert_array_equal(got[j], want)


def test_gram_ranks_equal_jax_formula():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((300, 24)).astype(np.float32)
    q = (g[:50] + 0.3 * rng.standard_normal((50, 24))).astype(np.float32)
    pos = rng.integers(0, 300, 50).astype(np.int32)

    @jax.jit
    def jax_ranks(q, g, p):  # scripts/probe_ann_learned.py:233-240
        d = ((q * q).sum(-1, keepdims=True)
             - 2.0 * q @ g.T + (g * g).sum(-1)[None, :])
        dp = jnp.take_along_axis(d, p[:, None], axis=1)
        return 1 + (d < dp).sum(1)

    want = np.asarray(jax_ranks(jnp.asarray(q), jnp.asarray(g),
                                jnp.asarray(pos)))
    got = ann.gram_ranks(torch.from_numpy(q), torch.from_numpy(g),
                         torch.from_numpy(pos.astype(np.int64)), chunk=16)
    np.testing.assert_array_equal(got, want)


def test_writer_leaves_no_stale_key(tmp_path):
    out = tmp_path / "torch_ann_learned_cpu.json"
    out.write_text(json.dumps({"run_name": "A", "stale": 1,
                               "ivf_pq_recall": {"np8_pure": 0.5,
                                                 "np64_pure": 0.9}}))
    ann.write_golden({"run_name": "A", "ivf_pq_recall": {"np8_pure": 0.6}},
                     out)
    assert json.loads(out.read_text()) == {
        "run_name": "A", "ivf_pq_recall": {"np8_pure": 0.6}}


def test_stages_end_to_end_at_a_tiny_size(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # cli/train.py exports models/<run>.pt
    got = ann.run(tmp_path / "data", tmp_path / "results", device="cpu",
                  corpus=dict(n_classes=3, photos_per_class=4,
                              sketches_per_photo=2, gen_size=64,
                              learnable=True),
                  epochs=1, image_size=64, n_distractor_classes=2,
                  photos_per_distractor=128, width=8, layers=(2, 1, 1, 1))
    tpu = json.loads((REPO / "goldens" / "ann_learned_tpu.json").read_text())
    assert set(tpu) <= set(got)
    assert set(got) - set(tpu) == {"wall_s"}  # no card fields on the CPU
    assert got["backend"] == "cpu"
    for key in ("tune_nprobe", "corpus"):
        assert sorted(got[key]) == sorted(tpu[key]), key
    assert got["n_distractors"] == 256
    assert got["n_gallery"] == got["n_paired"] + 256
    assert got["n_queries"] == 12  # the test half of 3 x 4 x 2 sketches
    assert sorted(got["ivf_recall"], key=int) == [
        str(p) for p in ann.NPROBES if p <= got["ivf_nlist"]]
    assert 0 < got["mrr"] <= 1 and 0 < got["chance_mrr"] < 1
    assert set(got["int8_overlap"]) == {"r40", "r80"}
    tn = got["tune_nprobe"]
    assert tn["serving_choice"] == min(2 * tn["proxy_choice"],
                                       got["ivf_nlist"])
    assert f"opq_np{tn['serving_choice']}_r640" in got["ivf_pq_recall"]
    assert Path("models", got["run_name"] + ".pt").is_file()


def test_probe_ivf_cli_prints_every_route(capsys):
    res = probe_ivf.main(["--n", "2000", "--rounds", "1", "--clustered",
                          "--device", "cpu"])
    err = capsys.readouterr().err
    routes = ["K1 f32", "K1 f32 gg", "K2 r40+rerank"] + [
        f"ivf p={p}" for p in probe_ivf.NPROBES]
    assert sorted(res["recall"]) == sorted(routes)
    for b in probe_ivf.BATCHES:
        assert sorted(res["ms_per_dispatch"][str(b)]) == sorted(routes)
        for tag in routes:
            assert f"B={b:>2} {tag:<14}" in err, (b, tag)
    for tag in routes:
        assert res["recall"][tag]["near"]["at10"] > 0.9, tag
    for tag in ("K1 f32", "K1 f32 gg"):
        assert res["recall"][tag]["near"] == {"at1": 1.0, "at10": 1.0}


def test_probe_pq_part_a_cli_prints_every_route(capsys):
    res = probe_pq.main(["--part", "a", "--n", "2000", "--rounds", "1",
                         "--device", "cpu"])
    err = capsys.readouterr().err
    for b in (1, 8, 32):
        for tag in ("ivf exact", "pq+rerank", "pq pure"):
            assert f"A: B={b:>2} {tag:<10}" in err, (b, tag)
    rec = res["a"]["recall_at_10"]
    assert rec["res-pq rerank-bf16"] >= rec["res-pq pure"]
    assert "b" not in res
