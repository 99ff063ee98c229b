"""Loss tracking, wall-clock timing and the profiler hook.

Counterpart of ``art_sbir_tpu/core/metrics.py``: loss accumulation per
epoch (reference `utils.py:92-102` ``process_losses``), the reference's
``training_time``/``inference_time`` (`inference.py:133`), and an
optional ``torch.profiler`` trace of training.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Iterator, List

import torch


class LossTracker:
    """Dict-keyed loss accumulator with 'add' and 'append' modes, as the
    reference ``process_losses`` (reference `utils.py:92-102`)."""

    def __init__(self, keys: List[str]):
        self.sums: Dict[str, float] = {k: 0.0 for k in keys}
        self.series: Dict[str, List[float]] = {k: [] for k in keys}

    def add(self, losses: Dict, size: int = 1) -> None:
        """Accumulate without a host sync: device scalars stay on the
        device (``0.0 + tensor`` is a tensor), so tracking every step does
        not wait for the card. ``append`` and host reads pay the sync,
        once a logging window."""
        for k in self.sums:
            self.sums[k] = self.sums[k] + losses[k] / size

    def append(self, losses: Dict, size: int = 1) -> None:
        for k in self.series:
            self.series[k].append(float(losses[k]) / size)

    def reset_sums(self) -> None:
        for k in self.sums:
            self.sums[k] = 0.0


class Timer:
    """Wall-clock timer; ``device_sync=True`` waits for the card's
    outstanding work (``torch.cuda.synchronize``) at every reading, so a
    time covers execution, not the enqueue."""

    def __init__(self, device_sync: bool = False):
        self._sync = device_sync
        self.start = self._now()

    def _now(self) -> float:
        if self._sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    def elapsed(self) -> float:
        return self._now() - self.start

    def restart(self) -> float:
        e = self.elapsed()
        self.start = self._now()
        return e


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None) -> Iterator[None]:
    """With a directory, trace the block with ``torch.profiler`` (the
    card's activity too where CUDA is present) and write a Chrome trace,
    ``<trace_dir>/trace.json``; without one, do nothing."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))
