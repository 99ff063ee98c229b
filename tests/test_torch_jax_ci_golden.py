"""The port's ``ci`` preset from JAX's seed-0 init lands on JAX's own
golden, ``goldens/ci_cpu.json`` (which JAX's ``cli/goldens.py`` reproduces
exactly on the CPU).

The port draws JAX's init (``models/flax_draw.py``), so what is left
between the two packages is the pipeline's arithmetic: bf16 on the CPU
(cli/train.py's default) at one torch thread under
``pin_ci_environment``, against XLA's. The tolerances:

* the final train and test losses within rel ``LOSS_RTOL`` = 3e-2 (from
  JAX's init the port lies 1.85% and 0.80% off; from its earlier torch
  draw it lay 37% and 2.5% off);
* the ranks of the 12 queries over the 9-photo gallery: the port's rank
  histogram (read off ``topk_acc``, which covers every rank here) is
  JAX's with at most ``MOVES`` = 2 queries moved one place each (the
  earth mover's distance between the two, in queries times places); MRR
  and the mean rank then lie within what two such moves allow.
"""

import json
from pathlib import Path

import pytest
import torch

from art_sbir_tpu_torch.cli import goldens as port_goldens

JAX_GOLDEN = Path(__file__).resolve().parents[1] / "goldens" / "ci_cpu.json"
LOSS_RTOL = 3e-2
MOVES = 2


@pytest.fixture
def one_thread():
    """``pin_ci_environment``, undone after the test (the worker runs
    other files next)."""
    threads = torch.get_num_threads()
    port_goldens.pin_ci_environment()
    yield
    torch.use_deterministic_algorithms(False)
    torch.set_num_threads(threads)


def cumulative_counts(golden: dict) -> list:
    """Queries ranked within the top k, k = 1 .. 10."""
    return [round(a * golden["n_queries"]) for a in golden["topk_acc"]]


def test_ci_preset_lands_on_jax_golden(tmp_path, one_thread, monkeypatch):
    monkeypatch.chdir(tmp_path)  # cli/train.py exports models/<run>.pt
    want = json.loads(JAX_GOLDEN.read_text())
    assert want["backend"] == "cpu" and want["preset"] == "ci"
    got = port_goldens.run("ci", tmp_path / "data", tmp_path / "results",
                           seed=want["seed"], device="cpu", bf16=True)
    assert (got["n_gallery"], got["n_queries"]) == (want["n_gallery"],
                                                    want["n_queries"])
    for key in ("final_train_loss", "final_test_loss"):
        assert got[key] == pytest.approx(want[key], rel=LOSS_RTOL), key
    # every rank is within the top 10: the top-k counts are the histogram
    assert want["n_gallery"] <= len(want["topk_acc"])
    moves = sum(abs(a - b) for a, b in zip(cumulative_counts(got),
                                           cumulative_counts(want)))
    assert moves <= MOVES, (got["topk_acc"], want["topk_acc"])
    n = want["n_queries"]
    # one place moves a reciprocal rank by at most 1 - 1/2
    assert abs(got["mrr"] - want["mrr"]) <= moves * 0.5 / n + 1e-12
    assert abs(got["rank_mean"] - want["rank_mean"]) <= moves / n + 1e-12
