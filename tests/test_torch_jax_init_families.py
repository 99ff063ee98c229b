"""InceptionV3's fresh init, and every family's at full width, against
JAX's on the CPU.

* ``create_inception(seed=s)`` (1000 classes, with ``AuxLogits``: a
  train-mode init, at 299 px, the smallest input that makes it) against
  JAX's ``InceptionV3().init(key(s), train=True)``, and without the aux
  head (``every_feat``) against the same values; JAX's eval-mode init
  (75 px) has the same values for the leaves both make, a leaf's key
  being a function of its path. By ``tests/test_torch_jax_init.py``'s
  rule: constants exact, drawn values within ``flax_draw.DRAW_ULP``
  float32 ulp, under 3% of them differing.
* ``goldens/torch_jax_init_families_seed0.json`` is a digest
  (``flax_draw.digest``) of JAX's seed-0 inits of the families
  ``flax_families.seed0_draws`` draws, at the full width of their entry
  points, under the keys the JAX CLIs use; ``chip_smoke.py``'s
  ``inventory`` phase holds the card host's draws to it. Each model is
  initialized at the smallest input it takes (its parameters' shapes do
  not depend on it). Rewrite the digest with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_jax_init_families.py
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from art_sbir_tpu_torch.models import flax_draw as FD
from art_sbir_tpu_torch.models import flax_families as FF
from art_sbir_tpu_torch.models import port_weights as PW
from tests.test_torch_init import _held, _init
from tests.torch_threads import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
DIGEST = ROOT / "goldens" / "torch_jax_init_families_seed0.json"


@functools.lru_cache(maxsize=None)
def _jax_inception(seed: int, train: bool) -> dict:
    from art_sbir_tpu.models.inception import InceptionV3

    size = 299 if train else 75
    keys = {"params": jax.random.key(seed), "dropout": jax.random.key(9)}
    v = _init(InceptionV3(), keys, jnp.zeros((1, size, size, 3)),
              train=train)
    return PW.inception_v3_from_flax(v["params"], v["batch_stats"])


@pytest.mark.parametrize("seed", [0, 1])
def test_inception_init(seed):
    from art_sbir_tpu_torch.models.inception import create_inception

    want = _jax_inception(seed, True)
    _held(want, create_inception(seed=seed).state_dict())
    bare = create_inception(every_feat=True, seed=seed).state_dict()
    _held({k: want[k] for k in bare}, bare)
    if seed == 0:
        evals = _jax_inception(0, False)
        assert set(evals) == set(bare)
        for k, w in evals.items():
            torch.testing.assert_close(w, want[k], rtol=0, atol=0)


def _jax_family(name: str) -> dict:
    """JAX's seed-0 init of the family ``name`` at full width, in the
    port's layout."""
    from art_sbir_tpu.models import adain_net as JA
    from art_sbir_tpu.models import pix2pix as JP
    from art_sbir_tpu.models.drawing import DrawingGenerator
    from art_sbir_tpu.models.photo2sketch import Photo2Sketch
    from art_sbir_tpu.models.transformer import ResidualAttentionBlock

    key = jax.random.key
    img = lambda s, c=3: jnp.zeros((1, s, s, c))  # noqa: E731
    if name.startswith("pix2pix"):
        kg, kd = jax.random.split(key(0))  # JAX train/gan.py:79
        if name == "pix2pix_g":
            v = _init(JP.define_g("resnet_9blocks", 1), kg, img(32),
                      train=False)
            return PW.pix2pix_g_from_flax("resnet_9blocks", v["params"],
                                          v["batch_stats"])
        v = _init(JP.define_d("basic"), kd, img(32, 4), train=False)
        return PW.pix2pix_d_from_flax("basic", v["params"],
                                      v["batch_stats"])
    if name == "photo2sketch":
        v = _init(Photo2Sketch(), key(0), img(32), jnp.zeros((1, 2, 5)),
                  key(0))
        return PW.photo2sketch_from_flax(v["params"])
    if name == "drawing_generator":
        return PW.drawing_from_flax(_init(DrawingGenerator(), key(0),
                                          img(32))["params"])
    if name == "adain":  # JAX cli/artwork_gen.py:49-50
        enc = _init(JA.AdaINEncoder(), key(0), img(32))["params"]
        dec = _init(JA.AdaINDecoder(), key(1), img(4, 512))["params"]
        enc, dec = PW.adain_from_flax(enc, dec)
        return {**{f"encoder.{k}": v for k, v in enc.items()},
                **{f"decoder.{k}": v for k, v in dec.items()}}
    if name == "inception_v3":
        return _jax_inception(0, True)
    v = _init(ResidualAttentionBlock(d_model=512, n_head=8), key(0),
              jnp.zeros((1, 5, 512)))
    return PW.residual_attention_block_from_flax(v["params"])


FAMILIES = tuple(FF.seed0_draws())


def jax_digest(name: str) -> dict:
    return FD.digest(_jax_family(name))


@pytest.mark.parametrize("name", FAMILIES)
def test_committed_digest_is_jax_init(name):
    """The committed digest of the family is JAX's own init (written by
    this module), and the port's draw meets it by ``digest_mismatches``'
    rule."""
    want = json.loads(DIGEST.read_text())
    assert sorted(want) == sorted(FAMILIES)
    assert want[name] == json.loads(json.dumps(jax_digest(name)))
    assert FD.digest_mismatches(FF.seed0_draws()[name](), want[name]) == []


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    lines = []
    for name in FAMILIES:
        record = jax_digest(name)
        lines.append(f"{json.dumps(name)}: {{\n" + ",\n".join(
            f"{json.dumps(k)}: {json.dumps(record[k], sort_keys=True)}"
            for k in sorted(record)) + "\n}")
    DIGEST.write_text("{\n" + ",\n".join(lines) + "\n}\n")
    print(f"wrote {DIGEST}")
