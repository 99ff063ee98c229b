"""The port's fresh init of the triplet encoder is JAX's: ``create_encoder(
seed=s, device="cpu")`` against ``model.init(jax.random.key(s), ...)``
carried into the port's layout by ``models/port_weights.py``, tensor by
tensor.

Constant tensors (biases, BatchNorm, its statistics) and the key set are
equal. Every drawn tensor (conv and dense kernels through flax's
``lecun_normal``, the positional embedding through ``normal``) goes
through the inverse error function, where the port's float32 evaluation
lies within 2 ulp of XLA's (``tests/test_torch_jax_random.py``); after
the scale by the init's std a weight lies within ``DRAW_ULP`` = 4 ulp of
JAX's (the widest measured: 4, at seed 0 on the flagship and the thin
shapes), and about 1% of the values differ at all.

``goldens/torch_jax_init_seed0.json`` is a digest of JAX's seed-0 init
of the flagship (``ModifiedResNetWithClassification``, 224 px, 125
classes) that ``chip_smoke.py``'s ``inventory`` phase holds the card
host's draw to. Rewrite it with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_jax_init.py
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu_torch.core import jax_random as jr
from art_sbir_tpu_torch.models import flax_draw as FD
from art_sbir_tpu_torch.models import port_weights as PW
from tests.torch_threads import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
DIGEST = ROOT / "goldens" / "torch_jax_init_seed0.json"
THIN = dict(width=8, layers=(2, 1, 1, 1))  # at 64 px
FLAGSHIP = dict(width=64, layers=(3, 4, 6, 3))


@functools.lru_cache(maxsize=None)
def _jax_init(heads: tuple, res: int, geo: tuple):
    """A jitted ``model.init`` (key -> variables) for one configuration:
    compiled once, called for each seed. ``heads``: () or the classes of
    one or two heads."""
    from art_sbir_tpu.models.resnet import create_encoder as jax_encoder

    jm = jax_encoder(with_classification=bool(heads),
                     num_classes=heads[0] if heads else 125,
                     num_classes2=heads[1] if len(heads) > 1 else 0,
                     dtype=jnp.float32, input_resolution=res, **dict(geo))
    x = jnp.zeros((1, res, res, 3), jnp.float32)
    return jax.jit(lambda k: jm.init(k, x, train=False))


def jax_state(seed: int, heads: tuple, res: int, **geo) -> dict:
    """JAX's init of the configuration in the port's layout."""
    v = _jax_init(heads, res, tuple(sorted(geo.items())))(
        jax.random.key(seed))
    layers = geo["layers"]
    if heads:
        return PW.modified_resnet_with_classification_from_flax(
            v["params"], v["batch_stats"], layers)
    return PW.modified_resnet_from_flax(v["params"], v["batch_stats"],
                                        layers)


def port_state(seed: int, heads: tuple, res: int, **geo) -> dict:
    from art_sbir_tpu_torch.models.resnet import create_encoder

    model = create_encoder(with_classification=bool(heads),
                           num_classes=heads[0] if heads else 125,
                           num_classes2=heads[1] if len(heads) > 1 else 0,
                           device="cpu", compute_dtype=torch.float32,
                           seed=seed, input_resolution=res, **geo)
    return model.state_dict()


def compare(want: dict, have: dict) -> dict:
    """Every rule of the module docstring; returns the widest distance and
    the share of drawn values that differ."""
    assert sorted(want) == sorted(have)
    widest, differ, drawn = 0, 0, 0
    for key, w in want.items():
        h = have[key]
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        h = h.detach().numpy()
        assert w.shape == h.shape, key
        if not np.issubdtype(w.dtype, np.floating) or np.all(w == w.flat[0]):
            np.testing.assert_array_equal(h, w, err_msg=key)
            continue
        d = jr.ulp_distance(h, w)
        assert d.max() <= FD.DRAW_ULP, (key, int(d.max()))
        widest = max(widest, int(d.max()))
        differ += int((d > 0).sum())
        drawn += d.size
    return {"widest": widest, "share": differ / drawn}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("heads", [(), (5, 3)], ids=["backbone", "heads"])
def test_thin_encoder_is_jax_init(seed, heads):
    """The bare tower (its parameters at the root of flax's tree) and the
    tower under ``backbone`` with both heads (``classifier2`` is the
    root's second child: a path of its own)."""
    got = compare(jax_state(seed, heads, 64, **THIN),
                  port_state(seed, heads, 64, **THIN))
    assert got["share"] < 0.03, got


@functools.lru_cache(maxsize=None)
def flagship_states() -> tuple:
    """JAX's and the port's seed-0 flagship inits (224 px, 125 classes),
    drawn once for this module's flagship tests."""
    return (jax_state(0, (125,), 224, **FLAGSHIP),
            port_state(0, (125,), 224, **FLAGSHIP))


def test_flagship_encoder_is_jax_init():
    """The full-width, full-depth tower with its 125-class head, at its
    224 px."""
    got = compare(*flagship_states())
    assert got["share"] < 0.03, got


def test_init_weights_reads_the_configuration_off_the_model():
    """``init_weights`` on a model built by hand equals ``create_encoder``'s
    init, and seeds differ."""
    from art_sbir_tpu_torch.models import resnet as R

    geo = dict(width=8, layers=(1, 1, 1, 1), input_resolution=64,
               output_dim=32, heads=4)
    a = R.init_weights(R.ModifiedResNet(**geo), 3).state_dict()
    b = R.create_encoder(device="cpu", seed=3, compute_dtype=torch.float32,
                         **geo).state_dict()
    c = R.init_weights(R.ModifiedResNet(**geo), 4).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])


def flagship_digest() -> dict:
    """The digest of JAX's seed-0 flagship init (224 px, 125 classes)."""
    return FD.digest({k: torch.as_tensor(np.array(v)) for k, v in
                      flagship_states()[0].items()})


def test_committed_digest_is_jax_init():
    """The committed digest is JAX's own init (written by this module),
    and the port's draw meets it by ``digest_mismatches``' rule."""
    want = json.loads(DIGEST.read_text())
    assert want == json.loads(json.dumps(flagship_digest()))
    assert FD.digest_mismatches(flagship_states()[1], want) == []


def test_digest_mismatches_catch_a_moved_value():
    """A value one past the bound, a scaled tensor and a missing one are
    each reported."""
    state = port_state(0, (5,), 64, **THIN)
    want = FD.digest(state)
    moved = {k: v.clone() for k, v in state.items()}
    w = moved["conv1.weight"].view(-1)
    bits = w[:1].numpy().view(np.int32)
    bits += FD.DRAW_ULP + 1
    moved["layer1.0.conv2.weight"].mul_(1.001)
    del moved["classifier.bias"]
    bad = FD.digest_mismatches(moved, want)
    assert any(b.startswith("conv1.weight: a head value") for b in bad), bad
    assert any(b.startswith("layer1.0.conv2.weight: sum_sq") for b in bad)
    assert "classifier.bias: missing" in bad
    assert FD.digest_mismatches(state, want) == []


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    record = flagship_digest()
    DIGEST.write_text("{\n" + ",\n".join(
        f"{json.dumps(k)}: {json.dumps(record[k], sort_keys=True)}"
        for k in sorted(record)) + "\n}\n")
    print(f"wrote {DIGEST}")
