"""P1: the port's ablation levels against the JAX package's
``_ablate_kernel``, on the CPU, and the port's ablation probe.

The JAX kernel lives in ``scripts/probe_fused_overhead.py``, whose
``run_ablate`` has no interpret switch; the test loads the script with
``importlib`` and wraps ``_ablate_kernel`` in a ``pl.pallas_call`` with the
script's BlockSpecs, in interpret mode (one query tile of all Q rows). The
port's wrapper runs its plain PyTorch version. Levels 1 and 2 count
integers and must be equal; level 0 truncates each tile's float32 row sum
to int32, and two orders of summation may land on either side of an
integer, so it may differ by one per tile. The data keep every distance
well away from ``d2pos``, and two queries equal small-integer gallery rows,
whose distance 0 is exact in any order, so level 2's count of distances
<= 1e-6 is not left to rounding either. The CUDA kernel is held against
the plain version by the ``cuda``-marked tests and by ``chip_smoke.py``.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from art_sbir_tpu_torch.ops import fused_ablation as fa
from art_sbir_tpu_torch.scripts import probe_fused_overhead as probe
from tests.torch_threads import two_torch_threads  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=1)
def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_fused_overhead", ROOT / "scripts" / "probe_fused_overhead.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_ablate(q, g, qq, gg, d2pos, pos2d, level, tile_n):
    nq, d = q.shape
    n = g.shape[0]
    kernel = functools.partial(_jax_probe()._ablate_kernel, level=level,
                               tile_n=tile_n, n_total=n)
    spec_q = pl.BlockSpec((nq, d), lambda tq, tn: (tq, 0),
                          memory_space=pltpu.VMEM)
    spec_c1 = pl.BlockSpec((nq, 1), lambda tq, tn: (tq, 0),
                           memory_space=pltpu.VMEM)
    return pl.pallas_call(
        kernel,
        grid=(1, n // tile_n),
        in_specs=[spec_q, spec_c1, spec_c1, spec_c1,
                  pl.BlockSpec((tile_n, d), lambda tq, tn: (tn, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, tile_n), lambda tq, tn: (0, tn),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((nq, 1), lambda tq, tn: (tq, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((nq, 1), jnp.int32),
        interpret=True,
    )(q, qq, d2pos, pos2d, g, gg)


@functools.lru_cache(maxsize=None)
def _inputs(n, nq=16, d=128, seed=0):
    """bf16-valued float32 arrays: the gallery, queries near random rows,
    two of them equal to small-integer rows; the bf16 values' plain squared
    norms; d2pos halfway between each row's 40th and 41st smallest distance
    (of a float64 reference), so that 40 or 41 columns are hits."""
    rng = np.random.default_rng(seed + n)

    def bf(x):  # round to bf16, as float32
        return np.array(jnp.asarray(x, jnp.float32).astype(
            jnp.bfloat16).astype(jnp.float32))

    g = bf(rng.standard_normal((n, d)))
    g[[5, n - 7]] = rng.integers(-3, 4, (2, d))
    pos = rng.integers(0, n, nq).astype(np.int32)
    q = bf(g[pos] + 1.5 * rng.standard_normal((nq, d)))
    q[[0, 1]] = g[[5, n - 7]]
    qq = np.sum(q * q, 1, keepdims=True, dtype=np.float32)
    gg = np.sum(g * g, 1, dtype=np.float32)[None, :]
    d2 = np.sort(np.sum((q[:, None, :].astype(np.float64) - g[None]) ** 2,
                        axis=2), axis=1)
    d2pos = (0.5 * (d2[:, 40] + d2[:, 41])).astype(np.float32)[:, None]
    return q, g, qq, gg, d2pos, pos[:, None]


def _port(arrays, level, tile_n):
    q, g, qq, gg, d2pos, pos2d = (torch.from_numpy(a) for a in arrays)
    return fa.ablate(q.to(torch.bfloat16), g.to(torch.bfloat16), qq, gg,
                     d2pos, pos2d, level=level, tile_n=tile_n).numpy()


def _jax(arrays, level, tile_n):
    q, g, qq, gg, d2pos, pos2d = (jnp.asarray(a) for a in arrays)
    return np.asarray(_jax_ablate(q.astype(jnp.bfloat16),
                                  g.astype(jnp.bfloat16), qq, gg, d2pos,
                                  pos2d, level, tile_n))


@pytest.mark.parametrize("tile_n", [256, 1024])
@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_matches_pallas_kernel(level, n, tile_n):
    arrays = _inputs(n)
    want, got = _jax(arrays, level, tile_n), _port(arrays, level, tile_n)
    assert got.dtype == np.int32 and got.shape == (16, 1)
    if level == 0:
        assert np.abs(got.astype(np.int64) - want).max() <= n // tile_n
    else:
        np.testing.assert_array_equal(got, want)


def test_levels_count_what_they_should():
    """Level 1 finds 40 or 41 hits a row (41 columns lie closer than
    d2pos, less the positive's own if it is one of them);
    level 2 adds one for each query equal to a gallery row."""
    arrays = _inputs(2048)
    rank, top2 = _port(arrays, 1, 1024), _port(arrays, 2, 1024)
    assert ((rank == 40) | (rank == 41)).all()
    np.testing.assert_array_equal(top2 - rank, [[1]] * 2 + [[0]] * 14)


def test_level_0_depends_on_the_tile():
    """Level 0 truncates each tile's sum: the tile width is part of the
    contract."""
    arrays = _inputs(2048)
    assert not np.array_equal(_port(arrays, 0, 128), _port(arrays, 0, 2048))


def test_guards():
    q, g, qq, gg, d2pos, pos2d = (torch.from_numpy(a) for a in _inputs(1024))
    args = (q, g[:1000], qq, gg[:, :1000], d2pos, pos2d)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        fa.ablate(*args, level=1)
    with pytest.raises(ValueError, match="tile_n must be a multiple of 128"):
        fa.ablate(q, g, qq, gg, d2pos, pos2d, level=1, tile_n=100)
    with pytest.raises(ValueError, match="level"):
        fa.ablate(q, g, qq, gg, d2pos, pos2d, level=3)


def test_cpu_route_launches_no_kernel():
    q, g, qq, gg, d2pos, pos2d = (torch.from_numpy(a) for a in _inputs(1024))
    before = fa.counters.launches
    fa.ablate(q, g, qq, gg, d2pos, pos2d, level=2)
    assert fa.counters.launches == before


def test_probe_runs_on_the_cpu(capsys):
    """The port's probe at a tiny size with --device cpu: every
    configuration timed and printed, N rounded down to whole tiles."""
    assert probe.main(["2100", "8", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "rounded down to 2048" in out
    assert "host clock on the CPU" in out
    table = [ln.split(":")[0].strip() for ln in out.splitlines()
             if ln.endswith("of full")]
    assert table == list(probe.CONFIGS)


def test_probe_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe.run(2048, 8, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_cuda_kernel_matches_plain_version(level):
    """On the card: P1 against its plain version, at two tiles' widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run by chip_smoke.py)")
    q, g, qq, gg, d2pos, pos2d = (torch.from_numpy(a).cuda()
                                  for a in _inputs(2048))
    args = (q.to(torch.bfloat16), g.to(torch.bfloat16), qq, gg, d2pos, pos2d)
    for tile_n in (256, 1024):
        out = fa.ablate_cuda(*args, level=level, tile_n=tile_n)
        ref = fa.ablate_reference(*args, level=level, tile_n=tile_n)
        err = (out.long() - ref.long()).abs().max().item()
        assert err <= (2048 // tile_n if level == 0 else 0)
