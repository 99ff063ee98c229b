"""The JAX package's fresh init of the triplet encoder, drawn without JAX,
and the machinery every other family's draw shares
(``models/flax_families.py``: a spec a family over :func:`flax_tree`).

``create_train_state(model, jax.random.key(seed), ...)`` in the JAX
package (``train/triplet.py:65-72``) runs flax's ``model.init``, whose
weights are a pure function of the seed: each parameter's key is the
root key with its module path and creation count folded in
(``flax/core/scope.py``: ``LazyRng``, ``_fold_in_static`` and
``make_rng``), and its value that key through flax's initializer. This
module computes the same keys and values with
:mod:`art_sbir_tpu_torch.core.jax_random`, for ``ModifiedResNet`` and
``ModifiedResNetWithClassification`` (JAX ``models/resnet.py:40-213``),
and carries the tree into the port's layout with
``models/port_weights.py``:

* a parameter's key: ``fold_in(root, h)``, ``h`` the first 4 bytes
  (big-endian) of the SHA-1 of its scope's path names and the scope's
  count of parameters made so far, this one included (an int as its
  minimal big-endian bytes), with no separator between them (flax 0.12's
  default, ``flax_fix_rng_separator`` off);
* conv and dense kernels: ``lecun_normal``, a normal truncated to two
  stds, times ``sqrt(1 / fan_in) / 0.8796`` (the truncated normal's
  std), in flax's HWIO and (in, out) shapes;
* biases zero, BatchNorm the identity (scale 1, bias 0, mean 0, var 1);
* the positional embedding ``normal / sqrt(C)`` (JAX ``resnet.py:96-100``);
* for the other families, ``normal * 0.02`` as jitted XLA computes it
  (``core/jax_random.py::normal``'s ``scale``), pix2pix's BatchNorm
  scale ``1 + 0.02 * normal`` and the LSTM's ``uniform * 2k``.

Tensors through the inverse error function (every kernel, the embedding)
lie within ``DRAW_ULP`` float32 ulp of JAX's (``core/jax_random.py``;
``tests/test_torch_jax_init.py`` holds it); the rest are equal.
:func:`digest` and :func:`digest_mismatches` hold a draw to a record of
JAX's own (``goldens/torch_jax_init_seed0.json``) on a host without
JAX. The draw runs on the host in float32 (the flagship's ~38M values take
about a second over 8 of the CPU's threads, by the host library of
``core/jax_random.py``) and is cached per configuration and seed for the
life of the process.
"""

from __future__ import annotations

import functools
import hashlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from art_sbir_tpu_torch.core import jax_random as jr

DRAW_ULP = 4  # the widest distance from JAX's of a drawn weight, in ulp
# std of a standard normal truncated to [-2, 2]: flax's ``lecun_normal``
# divides by it so that the truncated draw keeps variance 1 / fan_in
TRUNC_NORMAL_STD = 0.87962566103423978
Path = Tuple[str, ...]


def param_key(root: np.ndarray, path: Path, count: int) -> np.ndarray:
    """The key of the ``count``-th parameter made in the scope at
    ``path`` (flax's ``make_rng('params')``)."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(count.to_bytes((count.bit_length() + 7) // 8, "big"))
    return jr.fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def lecun_normal(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """flax's default kernel init: ``jax.nn.initializers.lecun_normal()``
    (fan_in: every axis but the last, the output's)."""
    fan_in = int(np.prod(shape[:-1]))
    std = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(TRUNC_NORMAL_STD)
    return jr.truncated_normal(k, -2.0, 2.0, shape) * std


# A spec lists a flax tree's leaves in the order their scopes make them:
# (scope path, leaf, kind, shape), a batch statistic's leaf under
# ``stats/``. The kinds:
#   lecun     flax's default kernel init (:func:`lecun_normal`)
#   normal    ``jax.random.normal * 0.02`` (``nn.initializers.normal(
#             0.02)``: pix2pix's kernels, ``ConvTranspose``'s default)
#   bn_scale  ``1 + 0.02 * normal`` (pix2pix's BatchNorm scale)
#   lstm      ``uniform * 2k``, ``k = 1 / sqrt(H)`` for a (., 4H) gate
#             leaf (``TorchLSTMCell``: its forward subtracts k)
#   pos       ``normal / sqrt(C)`` (the attention pool's embedding)
#   zeros, ones
Leaf = Tuple[Path, str, str, Tuple[int, ...]]
INIT_STD = np.float32(0.02)


def conv(out: List[Leaf], path: Path, kh: int, kw: int, cin: int,
         cout: int, bias: bool = True, kind: str = "lecun") -> None:
    """An ``nn.Conv``: HWIO kernel, then its bias."""
    out.append((path, "kernel", kind, (kh, kw, cin, cout)))
    if bias:
        out.append((path, "bias", "zeros", (cout,)))


def conv_transpose(out: List[Leaf], path: Path, k: int, cin: int,
                   cout: int, bias: bool = True, kind: str = "normal"
                   ) -> None:
    """JAX ``layers.py::ConvTranspose``: a (k, k, out, in) kernel."""
    out.append((path, "kernel", kind, (k, k, cout, cin)))
    if bias:
        out.append((path, "bias", "zeros", (cout,)))


def dense(out: List[Leaf], path: Path, cin: int, cout: int) -> None:
    out.append((path, "kernel", "lecun", (cin, cout)))
    out.append((path, "bias", "zeros", (cout,)))


def batch_norm(out: List[Leaf], path: Path, c: int, scale: str = "ones"
               ) -> None:
    out.append((path, "scale", scale, (c,)))
    out.append((path, "bias", "zeros", (c,)))
    out.append((path, "stats/mean", "zeros", (c,)))
    out.append((path, "stats/var", "ones", (c,)))


def _spec(layers: Sequence[int], width: int, pos_rows: int,
          output_dim: int, heads: Sequence[Tuple[str, int]]
          ) -> List[Leaf]:
    """The flax encoder's spec. ``heads``: the classifier heads (name,
    classes); with heads the backbone lives under ``backbone``."""
    pre: Path = ("backbone",) if heads else ()
    out: List[Leaf] = []
    half = width // 2
    for i, (cin, cout) in enumerate(((3, half), (half, half), (half, width)),
                                    start=1):
        conv(out, pre + (f"conv{i}",), 3, 3, cin, cout, bias=False)
        batch_norm(out, pre + (f"bn{i}",), cout)
    inplanes = width
    for stage, blocks in enumerate(layers, start=1):
        planes = width * 2 ** (stage - 1)
        for b in range(blocks):
            name = pre + (f"layer{stage}_{b}",)
            conv(out, name + ("conv1",), 1, 1, inplanes, planes, bias=False)
            batch_norm(out, name + ("bn1",), planes)
            conv(out, name + ("conv2",), 3, 3, planes, planes, bias=False)
            batch_norm(out, name + ("bn2",), planes)
            conv(out, name + ("conv3",), 1, 1, planes, planes * 4,
                 bias=False)
            batch_norm(out, name + ("bn3",), planes * 4)
            if (b == 0 and stage > 1) or inplanes != planes * 4:
                conv(out, name + ("downsample_conv",), 1, 1, inplanes,
                     planes * 4, bias=False)
                batch_norm(out, name + ("downsample_bn",), planes * 4)
            inplanes = planes * 4
    embed = width * 32
    out.append((pre + ("attnpool",), "positional_embedding", "pos",
                (pos_rows, embed)))
    for name, cout in (("q_proj", embed), ("k_proj", embed),
                       ("v_proj", embed), ("c_proj", output_dim)):
        dense(out, pre + ("attnpool", name), embed, cout)
    for name, classes in heads:
        dense(out, (name,), output_dim, classes)
    return out


def _value(root: np.ndarray, path: Path, count: int, kind: str,
           shape: Tuple[int, ...]) -> np.ndarray:
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "ones":
        return np.ones(shape, np.float32)
    k = param_key(root, path, count)
    if kind == "lecun":
        return lecun_normal(k, shape)
    if kind == "normal":
        return jr.normal(k, shape, INIT_STD)
    if kind == "bn_scale":
        return jr.normal(k, shape, INIT_STD) + np.float32(1)
    if kind == "lstm":
        bound = np.float32(2) * (np.float32(1)
                                 / np.sqrt(np.float32(shape[-1] // 4)))
        return jr.uniform(k, shape) * bound
    if kind == "pos":
        return jr.normal(k, shape) / np.float32(shape[1] ** 0.5)
    raise ValueError(f"unknown init {kind}")


def flax_tree(root: np.ndarray, spec: Sequence[Leaf]) -> Tuple[dict, dict]:
    """JAX's ``model.init`` under the key ``root`` of the model ``spec``
    describes, as nested dicts of numpy arrays: (params, batch_stats).
    A parameter's count is its place among its scope's parameters (every
    ``self.param`` draws a key, zeros too; batch statistics draw none)."""
    counts: Dict[Path, int] = {}
    jobs = []
    for path, leaf, kind, shape in spec:
        count = 0
        if not leaf.startswith("stats/"):
            count = counts[path] = counts.get(path, 0) + 1
        jobs.append((path, count, kind, shape))
    # the host library releases the interpreter lock: tensors side by side
    with ThreadPoolExecutor(max(1, torch.get_num_threads())) as pool:
        values = list(pool.map(lambda j: _value(root, *j), jobs))
    params: dict = {}
    stats: dict = {}
    for (path, leaf, _, _), v in zip(spec, values):
        tree, leaf = ((stats, leaf[6:]) if leaf.startswith("stats/")
                      else (params, leaf))
        for name in path:
            tree = tree.setdefault(name, {})
        tree[leaf] = v
    return params, stats


@functools.lru_cache(maxsize=8)
def encoder_state(seed: int, layers: Tuple[int, ...], width: int,
                  pos_rows: int, output_dim: int,
                  heads: Tuple[Tuple[str, int], ...] = ()
                  ) -> Dict[str, torch.Tensor]:
    """The port's state dict (CPU, float32) of JAX's seeded fresh init of
    ``ModifiedResNet`` (no ``heads``) or ``ModifiedResNetWithClassification``
    (``heads``: ``(("classifier", n),)`` or with ``("classifier2", n2)``).
    Cached: callers copy out of it and must not write into it."""
    # imported here: port_weights reaches models/resnet.py, which imports
    # this module
    from art_sbir_tpu_torch.models import port_weights as PW

    params, stats = flax_tree(jr.key(seed), _spec(layers, width, pos_rows,
                                                  output_dim, heads))
    if heads:
        return PW.modified_resnet_with_classification_from_flax(
            params, stats, layers)
    return PW.modified_resnet_from_flax(params, stats, layers)


def digest(state: Mapping[str, torch.Tensor], head: int = 16) -> dict:
    """A small record of a state dict's float tensors: for each, its
    shape, float64 sum, sum of magnitudes and sum of squares, the bits of
    its first ``head`` values, and how many ulp a value may lie from it
    (``DRAW_ULP`` where the tensor varies, 0 where it is constant)."""
    out = {}
    for name, t in state.items():
        if not t.is_floating_point():
            continue
        w = t.detach().cpu().float().contiguous().numpy().reshape(-1)
        w64 = w.astype(np.float64)
        out[name] = {
            "shape": list(t.shape), "sum": float(w64.sum()),
            "sum_abs": float(np.abs(w64).sum()),
            "sum_sq": float(np.square(w64).sum()),
            "head": [f"{v:08x}" for v in w[:head].view(np.uint32)],
            "ulp": DRAW_ULP if w.size and (w != w[0]).any() else 0}
    return out


def digest_mismatches(state: Mapping[str, torch.Tensor], want: Mapping
                      ) -> List[str]:
    """Where ``state`` departs from the record ``want`` (:func:`digest` of
    JAX's init): a missing or extra tensor, another shape, a head value
    more than the record's ulp away, or a sum, sum of squares or sum of
    magnitudes past what values each within that many ulp allow (a
    value within ``u`` ulp lies within ``u * 2^-23`` of itself,
    relatively; squares within twice that)."""
    have = digest(state, max(len(w["head"]) for w in want.values()))
    bad = [f"{k}: missing" for k in sorted(set(want) - set(have))]
    bad += [f"{k}: not in the record" for k in sorted(set(have) - set(want))]
    for k in sorted(set(want) & set(have)):
        w, h = want[k], have[k]
        if h["shape"] != w["shape"]:
            bad.append(f"{k}: shape {h['shape']} against {w['shape']}")
            continue
        u = w["ulp"]
        bits = lambda d: np.array([int(x, 16) for x in d["head"]],
                                  np.uint32).view(np.float32)
        far = jr.ulp_distance(bits(h), bits(w)).max(initial=0)
        if far > u:
            bad.append(f"{k}: a head value {far} ulp away (allowed {u})")
        rel = u * 2.0 ** -23
        for key, scale, factor in (("sum", "sum_abs", 1), ("sum_abs",
                                   "sum_abs", 1), ("sum_sq", "sum_sq", 2)):
            tol = (factor * rel + 1e-12) * w[scale]
            if abs(h[key] - w[key]) > tol:
                bad.append(f"{k}: {key} {h[key]!r} against {w[key]!r} "
                           f"(allowed {tol:.3g})")
    return bad
