"""Device meshes for the row-sharded gallery and the sharded embedding,
and the rows of a data-parallel rank.

Counterpart of ``art_sbir_tpu/parallel/mesh.py`` for its data axis. The
port's multi-device model is JAX's single controller: one process holds
an ordered list of devices, shard ``i`` of a gallery lives on
``mesh.devices[i]``, each shard's kernel runs on its own device's current
stream, and the (Q, k) partials are brought to ``mesh.devices[0]`` and
merged there (:mod:`art_sbir_tpu_torch.ops.sharded`). No process group
is needed. Training runs one process a device of the mesh instead
(:mod:`art_sbir_tpu_torch.parallel.multihost`); each keeps its rows of
a batch (:func:`shard_or_replicate`).

A mesh may name one device several times: ``[cpu] * 8`` on the CPU, or
``[cuda:0] * 4`` on one card, run that many shards on the one device,
as the JAX package's tests run 8 virtual CPU devices.

A mesh of ``n_model`` > 1 is JAX's 2-D ``(data, model)`` mesh
(:func:`~art_sbir_tpu_torch.parallel.tensor.mesh_2d`): ``devices`` holds
its ranks row-major, rank ``d * n_model + m`` at data index ``d`` and
model index ``m``; the trainers start a rank on each entry
(tensor parallelism, :mod:`~art_sbir_tpu_torch.parallel.tensor`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from art_sbir_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one named axis, or, with
    ``n_model`` > 1, a ``(data, model)`` grid of them, row-major."""

    devices: Tuple[torch.device, ...]
    axis_name: str = DATA_AXIS
    n_model: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def n_data(self) -> int:
        return self.size // self.n_model

    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        return list(dict.fromkeys(self.devices))

    def data_devices(self) -> List[torch.device]:
        """The data axis's devices (model index 0), each once: the cards a
        gallery shards over."""
        return list(dict.fromkeys(self.devices[::self.n_model]))


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """``data`` shards along ``axis_name`` (a 2-D mesh:
    ``tensor.mesh_2d``)."""

    data: int = 1
    axis_name: str = DATA_AXIS

    def build(self, devices: Optional[Sequence] = None) -> Mesh:
        """A mesh over the first ``data`` of ``devices`` (default: every
        card). A list may repeat a device."""
        devices = list(cuda_devices() if devices is None else devices)
        if self.data > len(devices):
            raise ValueError(f"MeshSpec wants {self.data} devices, only "
                             f"{len(devices)} present")
        return Mesh(tuple(_indexed(d) for d in devices[:self.data]),
                    self.axis_name)


def _indexed(device) -> torch.device:
    """``device`` with its index (``cuda`` -> ``cuda:<current>``), as a
    tensor on it reports its device."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS,
              device: str | torch.device | None = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` cards (``None`` or -1: all
    of them). With ``device='cpu'``, ``n_devices`` shards on the CPU (-1:
    one, the CPU being one device)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = 1 if n_devices is None or n_devices < 0 else n_devices
        return MeshSpec(n, axis_name).build([dev] * n)
    devices = cuda_devices()
    n = len(devices) if n_devices is None or n_devices < 0 else n_devices
    return MeshSpec(n, axis_name).build(devices)


def mesh_from_args(n_devices: int, tp_devices: int = 1,
                   device: str | torch.device | None = None,
                   multihost: bool = False) -> Optional[Mesh]:
    """The CLIs' mesh (JAX ``mesh_from_args``): ``None`` for ``n_devices``
    1 (or 0), else :func:`data_mesh` (-1: every card); the serving CLIs
    shard a gallery over it, the trainers start a rank on each of its
    devices. ``tp_devices`` > 1 makes the 2-D ``(data, model)`` mesh of
    ``n_devices`` data indices (-1: every card divided by
    ``tp_devices``), on the CPU that many ranks of the one CPU; it is
    single-host (``multihost`` exits). Exits with the mesh's message
    where fewer cards are present."""
    if tp_devices > 1:
        from art_sbir_tpu_torch.parallel.tensor import mesh_2d

        if multihost:
            raise SystemExit(
                "--tp_devices is single-host (combine with --n_devices "
                "for in-host data parallelism)")
        dev = resolve_device(device)
        devices = cuda_devices() if dev.type == "cuda" else None
        n_all = 1 if devices is None else len(devices)
        n_data = (max(n_all // tp_devices, 1) if n_devices < 0
                  else max(n_devices, 1))
        if devices is None:
            devices = [dev] * (n_data * tp_devices)
        try:
            mesh = mesh_2d(n_data, tp_devices, devices)
        except ValueError as e:
            raise SystemExit(f"--tp_devices {tp_devices}: {e}") from None
        print(f"mesh: {n_data} data x {tp_devices} model devices "
              "(params/opt-state/BN stats channel-sharded)", flush=True)
        return mesh
    if n_devices > 1 or n_devices < 0:
        try:
            mesh = data_mesh(n_devices, device=device)
        except ValueError as e:
            raise SystemExit(f"--n_devices {n_devices}: {e}") from None
        print(f"data mesh: {mesh.size} devices", flush=True)
        return mesh
    return None


def batch_rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of an ``n``-row batch over ``world`` ranks: its
    equal share, or every row where ``n`` does not divide (a ragged batch
    is replicated: each rank computes it whole, and the mean of equal
    gradients is the gradient)."""
    if n % world:
        return slice(0, n)
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_or_replicate(batch: Dict[str, Any], rank: Optional[int] = None,
                       world: Optional[int] = None
                       ) -> Tuple[Dict[str, Any], Tuple[int, int]]:
    """JAX ``shard_or_replicate`` for one rank (default: this process's
    data index among its group's, which a grid's model ranks share): the
    batch cut to :func:`batch_rows`, and ``(offset, total)``, where its
    rows start in the batch and the batch's length, which the trainers'
    random draws take (they draw for ``total`` rows and keep theirs). 0-d
    entries are kept whole."""
    from art_sbir_tpu_torch.parallel import multihost

    rank = multihost.data_rank() if rank is None else rank
    world = multihost.data_size() if world is None else world
    n = next(len(v) for v in batch.values() if getattr(v, "ndim", 1))
    sl = batch_rows(n, rank, world)
    return ({k: v[sl] if getattr(v, "ndim", 1) else v
             for k, v in batch.items()}, (sl.start, n))


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m


def shard_rows(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Shard ``i`` of ``t``'s rows, the contiguous ``N / S`` rows from
    ``i * N / S``, on ``mesh.devices[i]`` (a view where ``t`` lies there
    already)."""
    n, s = t.shape[0], mesh.size
    if n % s:
        raise ValueError(
            f"rows ({n}) must be divisible by the '{mesh.axis_name}' mesh "
            f"axis ({s}); pad them (see parallel.mesh.pad_to_multiple)")
    nl = n // s
    return [t[i * nl:(i + 1) * nl].to(d) for i, d in enumerate(mesh.devices)]


def split_batch(x: torch.Tensor, devices: Sequence[torch.device]
                ) -> List[torch.Tensor]:
    """The batch ``x`` cut into at most ``len(devices)`` contiguous parts
    of nearly equal size (none empty), part ``i`` on ``devices[i]``."""
    parts = torch.tensor_split(x, min(len(devices), max(x.shape[0], 1)))
    return [p.to(d) for p, d in zip(parts, devices) if p.shape[0]]
