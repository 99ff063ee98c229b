"""Named, order-independent streams of seeded ``torch.Generator``s.

Counterpart of ``art_sbir_tpu/core/prng.py``. The JAX package folds a
name's id and a step into one root ``jax.random.key``; here the seed,
the name's id and the step are mixed by a fixed integer hash into the
seed of a new ``torch.Generator``. Host-side sampling keeps
``numpy.random.Generator`` / ``random.Random`` at the reference's
documented seeds, as in the JAX package.

The mix is SplitMix64's finalizer (Steele, Lea and Flood, "Fast
splittable pseudorandom number generators", OOPSLA 2014) chained over
the three words: ``h = f(f(f(seed) ^ name_id) ^ step)`` in 64-bit
arithmetic. The streams cannot equal ``jax.random``'s; what carries over
is the discipline: the generator for ``(name, step)`` is a function of
the seed, the name and the step alone.
"""

from __future__ import annotations

from typing import Dict, Iterator

import torch

MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """SplitMix64's step and finalizer on a 64-bit word."""
    z = (x + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def mix_seed(seed: int, name_id: int, step: int) -> int:
    """The generator seed of ``(seed, name_id, step)``."""
    h = splitmix64(seed & MASK64)
    h = splitmix64(h ^ (name_id & MASK64))
    return splitmix64(h ^ (step & MASK64))


class RngStream:
    """A stream of seeded generators, one for each ``(name, step)``.

    Deterministic: the generator for (name, step) never depends on call
    order. The generators are the CPU's, so a stream draws the same
    numbers on every machine; callers move what they draw."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._names: Dict[str, int] = {}

    def _name_id(self, name: str) -> int:
        """FNV-1a (32-bit) of the name's UTF-8 bytes, as the JAX package
        hashes it: stable, unlike Python's randomized ``hash``."""
        if name not in self._names:
            h = 2166136261
            for ch in name.encode():
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            self._names[name] = h
        return self._names[name]

    def key(self, name: str, step: int = 0) -> torch.Generator:
        return torch.Generator().manual_seed(
            mix_seed(self.seed, self._name_id(name), step))

    def keys(self, name: str, start: int = 0) -> Iterator[torch.Generator]:
        step = start
        while True:
            yield self.key(name, step)
            step += 1
