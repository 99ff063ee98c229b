"""The port's ModifiedResNet against the JAX package's flax encoder.

One synthesized reference-layout state dict (``tests/test_torch_port.py``,
tamed as in ``tests/test_encoder_parity.py``) goes through ``torch_port``
into flax; the flax trees come back through ``modified_resnet_from_flax``
into the port. Eval mode. float32 at rtol 1e-4 (the bound
``test_encoder_parity.py`` uses). bf16 at a relative L2 error of 2e-2 and
a cosine of 0.999: bf16 keeps 8 significant bits (0.4% per rounding).
Both normalize BN in float32 and cast once to bf16 (flax's
``_normalize`` promotes a bf16 input against the float32 statistics);
``tests/test_torch_bf16_parity.py`` holds that against statistics far
from 0 and 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_sbir_tpu.models import torch_port as TP
from art_sbir_tpu.models.resnet import ModifiedResNet as FlaxResNet
from art_sbir_tpu.models.resnet import (
    ModifiedResNetWithClassification as FlaxResNetCls)
from art_sbir_tpu_torch.core.checkpoint import (load_state_dict,
                                                save_state_dict)
from art_sbir_tpu_torch.models import port_weights as PW
from art_sbir_tpu_torch.models import resnet as R
from art_sbir_tpu_torch.models.layers import BN_MOMENTUM
from tests.test_encoder_parity import _tame
from tests.test_torch_port import _fake_resnet_state_dict
from tests.torch_threads import two_torch_threads  # noqa: F401


LAYERS = (2, 1, 1, 1)
WIDTH, HEADS, OUT_DIM, RES = 8, 4, 32, 64
GEOM = dict(layers=LAYERS, output_dim=OUT_DIM, heads=HEADS,
            input_resolution=RES, width=WIDTH)


def _sd(rng, heads=0):
    sd = _tame(_fake_resnet_state_dict(rng, LAYERS, width=WIDTH,
                                       out_dim=OUT_DIM))
    for name, n in (("classifier", 5), ("classifier2", 3))[:heads]:
        sd[f"{name}.weight"] = (0.1 * rng.standard_normal((n, OUT_DIM))
                                ).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return sd


def _flax(sd, heads=0, dtype=jnp.float32):
    """(flax model, numpy params, numpy batch_stats) from a reference sd."""
    if heads:
        model = FlaxResNetCls(num_classes=5, num_classes2=3 if heads == 2
                              else 0, dtype=dtype, **GEOM)
        params, stats = TP.port_modified_resnet_with_classification(
            sd, LAYERS, num_classes=5)
    else:
        model = FlaxResNet(dtype=dtype, **GEOM)
        params, stats = TP.port_modified_resnet(sd, LAYERS)
    # the ported trees are complete, so no (slow, eager) flax init
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return model, to_np(params), to_np(stats)


def _port(state_dict, heads=0, dtype=torch.float32):
    if heads:
        model = R.ModifiedResNetWithClassification(
            num_classes=5, num_classes2=3 if heads == 2 else 0,
            compute_dtype=dtype, **GEOM)
    else:
        model = R.ModifiedResNet(compute_dtype=dtype, **GEOM)
    model.load_state_dict(state_dict)
    return model.eval()


def _run_both(rng, heads=0, dtype=(jnp.float32, torch.float32)):
    sd = _sd(rng, heads)
    x = rng.standard_normal((3, RES, RES, 3)).astype(np.float32)
    model, params, stats = _flax(sd, heads, dtype[0])
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    convert = (PW.modified_resnet_with_classification_from_flax if heads
               else PW.modified_resnet_from_flax)
    port = _port(convert(params, stats, LAYERS), heads, dtype[1])
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    if not heads:
        want, got = (want,), (got,)
    return ([np.asarray(w, np.float32) for w in want],
            [g.float().numpy() for g in got], sd, port, x)


def test_encoder_matches_flax_f32(rng):
    (want,), (got,), _, _, _ = _run_both(rng)
    assert got.shape == (3, OUT_DIM)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_reference_state_dict_loads_natively(rng):
    """A reference-layout state dict loads into the port as it is and gives
    the same embeddings as the flax round trip."""
    (_,), (got,), sd, _, x = _run_both(rng)
    port = _port({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
                 | {k: torch.tensor(0) for k in _port_keys()
                    if k.endswith("num_batches_tracked")})
    with torch.no_grad():
        native = port(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(native, got)


def _port_keys():
    return R.ModifiedResNet(**GEOM).state_dict().keys()


def test_state_dict_keys_are_the_reference_layout(rng):
    ref = set(_sd(rng))
    ours = {k for k in _port_keys() if not k.endswith("num_batches_tracked")}
    assert ours == ref
    assert "layer1.0.downsample.0.weight" in ours
    assert "attnpool.q_proj.weight" in ours


@pytest.mark.parametrize("heads", [1, 2])
def test_classification_heads_match_flax(rng, heads):
    want, got, _, _, _ = _run_both(rng, heads)
    assert len(got) == heads + 1
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_encoder_matches_flax_bf16(rng):
    (want,), (got,), _, _, _ = _run_both(
        rng, dtype=(jnp.bfloat16, torch.bfloat16))
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    cos = np.sum(got * want, 1) / (np.linalg.norm(got, axis=1)
                                   * np.linalg.norm(want, axis=1))
    assert rel < 2e-2 and cos.min() > 0.999, (rel, cos)


def test_bn_momentum_is_flax_09():
    """torch momentum weighs the NEW statistic: 0.1 == flax's 0.9 decay."""
    assert BN_MOMENTUM == pytest.approx(1 - 0.9)
    bn = R.ModifiedResNet(**GEOM).bn1
    assert bn.momentum == BN_MOMENTUM and bn.eps == 1e-5


def test_create_encoder_seeded_fresh_init():
    a = R.create_encoder(device="cpu", seed=3, compute_dtype=torch.float32,
                         **GEOM)
    b = R.create_encoder(device="cpu", seed=3, compute_dtype=torch.float32,
                         **GEOM)
    c = R.create_encoder(device="cpu", seed=4, compute_dtype=torch.float32,
                         **GEOM)
    assert not a.training
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
    x = torch.randint(0, 255, (2, RES, RES, 3), dtype=torch.uint8)
    with torch.no_grad():
        out = a(x.float())
    assert out.shape == (2, OUT_DIM) and torch.isfinite(out).all()


def test_checkpoint_round_trip(tmp_path):
    model = R.create_encoder(device="cpu", seed=1, with_classification=True,
                             num_classes=5, num_classes2=3, **GEOM)
    path = tmp_path / "models" / "Run.pt"
    save_state_dict(path, model.state_dict())
    other = R.create_encoder(device="cpu", seed=2, with_classification=True,
                             num_classes=5, num_classes2=3, **GEOM)
    other.load_state_dict(load_state_dict(path))
    for k, v in model.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k
