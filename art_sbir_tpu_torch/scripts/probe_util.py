"""What the IVF and PQ probes share: logging, dispatch timing and the
clustered gallery.

The JAX probes timed through a remote TPU and subtracted its round trip
(``bench.py``); the card is local, so a dispatch is timed whole with
CUDA events after a synchronize (host clock on the CPU).
"""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Dict, Sequence, Tuple

import torch

from art_sbir_tpu_torch.ops.ivf import _generator


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def dispatch_ms(fn: Callable[[], object], device: torch.device) -> float:
    """Milliseconds of one call of ``fn``, from dispatch to its host pull
    (``fn`` ends by copying its result to the host). On the card: CUDA
    events recorded around the call after a synchronize, so the interval
    covers the host work inside it."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def best_ms(routes: Sequence[Tuple[str, Callable[[], object]]], rounds: int,
            device: torch.device) -> Dict[str, float]:
    """Each route's best :func:`dispatch_ms` over ``rounds``, the routes
    interleaved within a round (a first call of each warms it)."""
    for _, fn in routes:
        fn()
    best = {tag: math.inf for tag, _ in routes}
    for _ in range(rounds):
        for tag, fn in routes:
            best[tag] = min(best[tag], dispatch_ms(fn, device))
    return best


def blob_centres(gen: torch.Generator, n_blobs: int, d: int,
                 device: torch.device) -> torch.Tensor:
    """Blob centres drawn as 4 N(0, 1): the JAX probes' clustered
    geometry, where real image-embedding galleries concentrate around
    semantic modes."""
    return 4.0 * torch.randn((n_blobs, d), generator=gen, device=device)


def blob_rows(gen: torch.Generator, n: int, centres: torch.Tensor
              ) -> torch.Tensor:
    """``n`` rows, each a uniformly drawn centre plus 0.5 N(0, 1)."""
    assign = torch.randint(0, centres.shape[0], (n,), generator=gen,
                           device=centres.device)
    return centres[assign] + 0.5 * torch.randn(
        (n, centres.shape[1]), generator=gen, device=centres.device)


def make_gallery(n: int, d: int, clustered: bool, device: torch.device,
                 seed: int = 17) -> torch.Tensor:
    """The probes' (n, d) gallery from a seeded generator on ``device``:
    ``clustered`` rows about max(4, sqrt(n)) blob centres, else N(0, 1)
    rows (the adversarially flat case)."""
    gen = _generator(seed, device)
    if not clustered:
        return torch.randn((n, d), generator=gen, device=device)
    centres = blob_centres(gen, max(4, int(math.sqrt(n))), d, device)
    return blob_rows(gen, n, centres)
