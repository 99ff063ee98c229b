"""Learning-rate schedules of the reference's scheduler factory
(reference `drawing_utils/networks.py:24-38` `get_scheduler`): linear
decay after ``n_epochs``, step decay and cosine, as plain functions of
the step, and the metric-reactive plateau rule as a host-side helper.

Counterpart of ``art_sbir_tpu/train/schedules.py``. Each schedule
returns the learning rate itself, in float32 arithmetic as JAX's
schedules compute it. ``torch.optim.lr_scheduler.LambdaLR`` multiplies
the optimizer's base rate by its function's value, so give it the
schedule over the base rate::

    sched = cosine_decay(lr, n_epochs)
    LambdaLR(optimizer, lambda step: sched(step) / lr)
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
F32 = np.float32


def _clip01(x: float) -> np.float32:
    return np.clip(F32(x), F32(0.0), F32(1.0))


def linear_decay(lr: float, n_epochs: int, n_epochs_decay: int,
                 steps_per_epoch: int = 1) -> Schedule:
    """Constant for ``n_epochs``, then linear to 0 over ``n_epochs_decay``."""

    def sched(step: int) -> float:
        epoch = step / steps_per_epoch
        frac = _clip01((epoch - n_epochs) / max(n_epochs_decay, 1))
        return float(F32(lr) * (F32(1.0) - frac))

    return sched


def step_decay(lr: float, decay_iters: int, gamma: float = 0.1,
               steps_per_epoch: int = 1) -> Schedule:
    def sched(step: int) -> float:
        epoch = step // steps_per_epoch
        return lr * gamma ** (epoch // decay_iters)

    return sched


def cosine_decay(lr: float, n_epochs: int, steps_per_epoch: int = 1,
                 eta_min: float = 0.0) -> Schedule:
    def sched(step: int) -> float:
        epoch = step / steps_per_epoch
        c = F32(1.0) + np.cos(F32(math.pi) * _clip01(epoch / n_epochs))
        return float(F32(eta_min) + F32((lr - eta_min) * 0.5) * c)

    return sched


class ReduceOnPlateau:
    """Host-side plateau scheduler (torch ReduceLROnPlateau semantics: min
    mode, factor, patience, threshold 1e-2 relative)."""

    def __init__(self, lr: float, factor: float = 0.2, patience: int = 5,
                 threshold: float = 0.01):
        self.lr = lr
        self.factor, self.patience = factor, patience
        self.threshold = threshold
        self.best = float("inf")
        self.bad_epochs = 0

    def update(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr
