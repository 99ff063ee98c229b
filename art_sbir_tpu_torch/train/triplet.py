"""Triplet training: the train state, the step functions and the epoch
loop.

Counterpart of ``art_sbir_tpu/train/triplet.py`` (reference
`train.py:39-98`):

* optimizer: ``torch.optim.Adam(lr, betas, eps, weight_decay)`` adds
  ``wd * p`` to the gradient before the moments, the update of the JAX
  package's ``optax.add_decayed_weights`` + ``optax.adam`` chain;
* BatchNorm: the reference runs three separate forwards a triplet, so
  each modality (sketch, positive, negative) is normalized by its own
  batch statistics and the running statistics take three sequential
  updates. Three train-mode forwards of the one module do exactly that
  (``models/resnet.py::BatchNorm2d`` updates as flax does);
* mixed precision: the model computes in its ``compute_dtype`` (bf16 by
  default) while parameters, gradients and optimizer state stay float32,
  as the JAX package's ``dtype=bf16`` does; no loss scaler is needed;
* the reference's iteration-eval bug (it re-evaluates the stale training
  batch, reference `train.py:79-81,89-91`) stays fixed: mini-evals take
  fresh test batches;
* data parallel (each rank in a ``torch.distributed`` group holding its
  rows of the batch, ``parallel/multihost.py``): BatchNorm takes the
  global batch's statistics, the gradients are averaged over the ranks
  before the Adam step, and the returned losses are the global batch's
  means, as JAX's step gives them under GSPMD. Outside a group the step
  is the one-device step;
* tensor parallel (a model made ``parallel/tensor.py::tensor_parallel``
  in a ``(data, model)`` grid): the same step, each rank holding its
  channel slices of the parameters, Adam's moments and the BatchNorm
  statistics; rows, BatchNorm statistics and the sharded gradients go by
  the data group. :class:`TrainState`'s state dict is in one device's
  layout (gathered), and loading one cuts it to the rank's slices.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from art_sbir_tpu_torch.core.metrics import Timer
from art_sbir_tpu_torch.parallel.multihost import (mean_over_ranks, rank,
                                                   reduce_gradients,
                                                   synced_batchnorm)
from art_sbir_tpu_torch.parallel.tensor import (gather_optimizer_state,
                                                gather_state,
                                                slice_optimizer_state,
                                                slice_state)
from art_sbir_tpu_torch.train.losses import (TripletLossConfig,
                                             triplet_loss_with_heads)

MODALITIES = ("sketch", "positive", "negative")


def torch_adam(params, lr: float, weight_decay: float = 0.0,
               betas=(0.9, 0.999), eps: float = 1e-8) -> torch.optim.Adam:
    """Adam with the L2 term added to the gradient before the moments
    (reference `train.py:158`: Adam(lr=1e-5, weight_decay=2e-3)). PyTorch's
    default implementation: not fused; the multi-tensor ``foreach`` form
    when every parameter is on the card, the per-tensor loop on the CPU."""
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps,
                            weight_decay=weight_decay)


class TrainState:
    """The model, its optimizer and the step count: what flax's
    ``TrainState`` holds, with the BatchNorm statistics in the model's
    buffers."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    def state_dict(self) -> Dict[str, Any]:
        """In one device's layout (under tensor parallelism every rank of
        the model group must call this: the slices are gathered)."""
        return {"model": gather_state(self.model),
                "optimizer": gather_optimizer_state(self.model,
                                                    self.optimizer),
                "step": self.step}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        """``d`` in one device's layout (cut to the rank's slices under
        tensor parallelism)."""
        self.model.load_state_dict(slice_state(self.model, d["model"]))
        self.optimizer.load_state_dict(slice_optimizer_state(
            self.model, self.optimizer, d["optimizer"]))
        self.step = int(d["step"])


def create_train_state(model: nn.Module, lr: float = 1e-5,
                       weight_decay: float = 2e-3) -> TrainState:
    return TrainState(model, torch_adam(model.parameters(), lr, weight_decay))


def forward3(model: nn.Module, batch: Dict[str, torch.Tensor]):
    """Sketch, positive and negative through ``model`` in its current mode,
    one forward each: in train mode each is normalized by its own batch
    statistics and the running statistics update three times in that
    order (JAX ``_forward3``)."""
    return [model(batch[k]) for k in MODALITIES]


def make_train_step(cfg: TripletLossConfig) -> Callable:
    """``train_step(state, batch) -> losses``: three train-mode forwards,
    the loss, backward and one Adam step. The losses come back detached,
    on the device (no host sync outside a group)."""

    def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with synced_batchnorm(state.model):
            s, p, n = forward3(state.model, batch)
        losses = triplet_loss_with_heads(cfg, s, p, n, batch.get("label"),
                                         batch.get("label2"))
        losses["loss"].backward()
        reduce_gradients(state.model.parameters())
        state.optimizer.step()
        state.step += 1
        return mean_over_ranks({k: v.detach() for k, v in losses.items()})

    return train_step


def make_eval_step(cfg: TripletLossConfig) -> Callable:
    """``eval_step(state, batch) -> losses`` in eval mode (running
    statistics), without gradients; the state does not change."""

    def eval_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        state.model.eval()
        with torch.no_grad():
            s, p, n = forward3(state.model, batch)
            return mean_over_ranks(triplet_loss_with_heads(
                cfg, s, p, n, batch.get("label"), batch.get("label2")))

    return eval_step


@dataclasses.dataclass
class TripletTrainer:
    """Epoch loop with the reference's logging cadence (reference
    `train.py:45-48`): iteration losses every 10000 // B train batches
    when epochs <= 6, mini test evals of 1000 // B batches. In a group
    every rank takes the checkpoint's state (tensor parallelism gathers
    it) and rank 0 writes it."""

    cfg: TripletLossConfig
    batch_size: int = 32
    epochs: int = 1
    checkpoint_manager: Optional[Any] = None  # core.checkpoint.CheckpointManager
    checkpoint_every_epochs: int = 1
    # optional per-epoch callback (epoch_1based, state) -> metrics dict,
    # collected under training_dict["epoch_metrics"]
    epoch_hook: Optional[Callable[[int, TrainState], Dict]] = None

    def __post_init__(self):
        self.train_step = make_train_step(self.cfg)
        self.eval_step = make_eval_step(self.cfg)

    def run(self, state: TrainState,
            train_batches: Callable[[], Iterable[Dict]],
            test_batches: Callable[[], Iterable[Dict]],
            log: Callable[[str], None] = lambda s: print(s, flush=True),
            start_epoch: int = 0) -> Tuple[TrainState, Dict]:
        timer = Timer()
        iter_freq = 10000 // self.batch_size if self.epochs <= 6 else 0
        itest_size = max(1000 // self.batch_size, 1)

        train_losses, test_losses = [], []
        itrain_losses, itest_losses = [], []
        step_times = []
        epoch_metrics = []

        def _eval_mean(st: TrainState, batches) -> float:
            """Accumulated on the device; one host sync at the end."""
            acc, k = 0.0, 0
            for tb in batches:
                acc = acc + self.eval_step(st, tb)["loss"]
                k += 1
            return float(acc) / max(k, 1)

        for epoch in range(start_epoch, self.epochs):
            # losses accumulate on the device so the steps stay queued;
            # the host syncs once a logging window
            running, window = 0.0, 0.0
            n_train = 0
            step_timer = Timer()
            step_seconds = 0.0
            for i, batch in enumerate(train_batches()):
                losses = self.train_step(state, batch)
                running = running + losses["loss"]
                window = window + losses["loss"]
                n_train += 1
                if iter_freq and i and i % iter_freq == 0:
                    itrain_losses.append(float(window) / iter_freq)  # syncs
                    step_seconds += step_timer.restart()
                    window = 0.0
                    # fresh test batches, not the stale training batch
                    # (reference train.py:79-81 bug)
                    itest_losses.append(_eval_mean(
                        state, itertools.islice(test_batches(), itest_size)))
                    step_timer.restart()  # eval time isn't step time

            train_losses.append(float(running) / max(n_train, 1))  # syncs
            step_seconds += step_timer.restart()
            step_times.append((step_seconds, n_train))
            test_losses.append(_eval_mean(state, test_batches()))
            log(f"Epoch {epoch + 1} - Train loss: {train_losses[-1]:.5f} | "
                f"Test loss: {test_losses[-1]:.5f}")
            if (self.checkpoint_manager is not None
                    and (epoch + 1) % self.checkpoint_every_epochs == 0):
                sd = state.state_dict()
                if rank() == 0:
                    self.checkpoint_manager.save(epoch + 1, sd)
            if self.epoch_hook is not None:
                m = {"epoch": epoch + 1, **self.epoch_hook(epoch + 1, state)}
                epoch_metrics.append(m)
                log(f"Epoch {epoch + 1} - " + " | ".join(
                    f"{k}: {v:.5f}" for k, v in m.items()
                    if k != "epoch" and isinstance(v, float)))

        n_steps = sum(n for _, n in step_times)
        training_dict = {
            "train_losses": train_losses,
            "test_losses": test_losses,
            "itrain_losses": itrain_losses,
            "itest_losses": itest_losses,
            "iteration_loss_frequency": iter_freq,
            "iteration_test_size": itest_size,
            "training_time": timer.elapsed(),
            # per-step time, read at the logging windows' host syncs
            "steps": n_steps,
            "mean_step_time": (sum(s for s, _ in step_times)
                               / max(n_steps, 1)),
        }
        if epoch_metrics:
            training_dict["epoch_metrics"] = epoch_metrics
        return state, training_dict
