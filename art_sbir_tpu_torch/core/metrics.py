"""Wall-clock timing.

Counterpart of ``art_sbir_tpu/core/metrics.py::Timer`` (the reference's
``inference_time``, reference `inference.py:133`). The loss trackers and
the profiler hook come with the training slice.
"""

from __future__ import annotations

import time

import torch


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
