"""Data-parallel training over several processes, one replica each.

Counterpart of ``art_sbir_tpu/parallel/multihost.py`` and of the data
axis the JAX trainers train over. Under GSPMD one program sees the
global batch, so JAX's BatchNorm statistics, random draws and gradient
reductions are global by construction. The port runs one process per
replica on ``torch.distributed`` and writes each of them out:

* **Launch.** :func:`spawn` starts one process per device of a list
  (``torch.multiprocessing``, start method ``spawn``), rank ``i`` on
  ``devices[i]``, joined through a ``FileStore`` in a temporary
  directory (no port to collide on), and returns rank 0's result. A
  rank that raises or dies makes :func:`spawn` raise once the others
  are stopped. :func:`initialize` joins a group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``): rank ``r`` on card ``LOCAL_RANK``; with no such
  environment it does nothing, as JAX's does on one process.
* **Backend.** NCCL where every rank has a card of its own, gloo where
  ranks share a device (the CPU, or one card repeated: NCCL refuses two
  ranks on one card). Only ``all_reduce``, ``broadcast`` and
  ``barrier`` are used, which gloo also runs on CUDA tensors. Every
  group has a timeout (:data:`GROUP_TIMEOUT`).
* **Rows.** Every rank iterates the same seeded order and keeps its
  rows (:func:`process_shard`); a batch that does not divide is tiled
  (the triplet loader) or replicated (``mesh.shard_or_replicate``).
  Random draws are made for the global batch from a generator that
  advances alike on every rank, and each rank keeps its rows.
* **Collectives.** :func:`reduce_gradients` (the mean of every
  ``.grad``, one flat buffer a dtype), :func:`mean_over_ranks` (logged
  losses), :func:`broadcast_state` (rank 0's parameters, buffers and
  optimizer state) and :func:`synced_batchnorm` (BatchNorm over the
  global batch, ``models/resnet.py::BatchNorm2d``).
* **The grid** (tensor parallelism, :mod:`.tensor`): :func:`init_grid`
  splits the ranks into ``n_data`` data indices of ``n_model`` model
  indices each (rank ``d * n_model + m``), with one data group a model
  index and one model group a data index. Rows, random draws, the
  synchronized BatchNorm, the logged losses and the sharded gradients
  then go by the data group (:func:`data_rank`, :func:`data_size`,
  :func:`data_group`); a replicated parameter's gradient is averaged
  over every rank, which keeps its copies equal; :func:`broadcast_state`
  sends each slice from data index 0 of its own model index.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

GROUP_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the ``(data, model)`` grid and its two
    groups."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any


_GRID: Optional[Grid] = None


def is_parallel() -> bool:
    """Whether this process belongs to a group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank (0 outside a group): JAX's ``process_index``."""
    return dist.get_rank() if is_parallel() else 0


def world_size() -> int:
    """The ranks of the group (1 outside one): JAX's ``process_count``."""
    return dist.get_world_size() if is_parallel() else 1


def init_grid(n_model: int) -> Grid:
    """Split the group into ``world / n_model`` data indices of ``n_model``
    ranks (rank ``d * n_model + m``): one data group a model index, one
    model group a data index. Every rank makes every group, in one order;
    asking again for the same ``n_model`` returns the grid made."""
    global _GRID
    if _GRID is not None and _GRID.n_model == n_model:
        return _GRID
    world, r = world_size(), rank()
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} ranks do not make a grid of {n_model} "
                         "model ranks")
    n_data = world // n_model
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    d, m = divmod(r, n_model)
    _GRID = Grid(n_data, n_model, d, m, data_groups[m], model_groups[d])
    return _GRID


def grid() -> Optional[Grid]:
    """The grid :func:`init_grid` made, or None."""
    return _GRID if is_parallel() else None


def data_rank() -> int:
    """This rank's data index: which rows of a batch it holds."""
    g = grid()
    return rank() if g is None else g.data_index


def data_size() -> int:
    """The data indices: how many parts a batch is cut into."""
    g = grid()
    return world_size() if g is None else g.n_data


def data_group():
    """The ranks that hold the other rows of this rank's batch (None: the
    whole group)."""
    g = grid()
    return None if g is None else g.data_group


def choose_backend(devices: Sequence) -> str:
    """``nccl`` where every rank has a card of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def init_group(rank_: int, world: int, device: torch.device, backend: str,
               store: Optional[dist.Store] = None,
               timeout: datetime.timedelta = GROUP_TIMEOUT) -> None:
    """Join the default group as ``rank_`` of ``world`` on ``device``
    (``store`` None: torchrun's ``env://``)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = ({"init_method": "env://"} if store is None else {"store": store})
    dist.init_process_group(backend, rank=rank_, world_size=world,
                            timeout=timeout, **kw)


def initialize(device: str | torch.device = "cuda",
               timeout: datetime.timedelta = GROUP_TIMEOUT
               ) -> Optional[torch.device]:
    """Join the group torchrun's environment describes and return this
    rank's device: card ``LOCAL_RANK``, or the CPU where ``device`` is
    ``'cpu'`` (gloo). Returns None, joining nothing, where
    ``WORLD_SIZE`` is unset or 1 (JAX ``multihost.initialize``)."""
    from art_sbir_tpu_torch.core.device import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    r = int(os.environ["RANK"])
    if resolve_device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", r)))
    backend = "gloo" if dev.type == "cpu" else "nccl"
    init_group(r, world, dev, backend, timeout=timeout)
    if r == 0:
        print(f"multihost: {world} ranks, backend {backend}", flush=True)
    return dev


def leave() -> None:
    """Leave the group, where this process is in one."""
    global _GRID
    _GRID = None
    if is_parallel():
        dist.destroy_process_group()


def _rank_main(i: int, fn: Callable, devices: Sequence, folder: str,
               backend: str, threads: int, timeout: datetime.timedelta,
               n_model: int, args: tuple) -> None:
    device = torch.device(devices[i])
    if device.type == "cpu":
        torch.set_num_threads(threads)
    init_group(i, len(devices), device, backend,
               dist.FileStore(str(Path(folder) / "store"), len(devices)),
               timeout)
    try:
        if n_model > 1:
            init_grid(n_model)
        out = fn(device, *args)
        if i == 0:
            (Path(folder) / "result.pkl").write_bytes(pickle.dumps(out))
    finally:
        leave()


def spawn(fn: Callable, devices: Sequence, *args, n_model: int = 1,
          timeout: datetime.timedelta = GROUP_TIMEOUT) -> Any:
    """``fn(device, *args)`` in one process per entry of ``devices``, rank
    ``i`` on ``devices[i]``, all in one group (a ``(len / n_model,
    n_model)`` grid where ``n_model`` > 1, :func:`init_grid`); returns
    rank 0's return value. ``fn`` must be importable (a module's
    top-level function). CPU ranks share this process's intra-op
    threads."""
    import torch.multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    backend = choose_backend(devices)
    n_cpu = sum(torch.device(d).type == "cpu" for d in devices)
    threads = max(1, torch.get_num_threads() // max(n_cpu, 1))
    print(f"data parallel: {len(devices)} ranks on {', '.join(devices)}, "
          f"backend {backend}", flush=True)
    with tempfile.TemporaryDirectory() as folder:
        mp.start_processes(_rank_main, nprocs=len(devices), join=True,
                           start_method="spawn",
                           args=(fn, devices, folder, backend, threads,
                                 timeout, n_model, args))
        return pickle.loads((Path(folder) / "result.pkl").read_bytes())


# ------------------------------------------------------------------ rows


def process_shard(n: int) -> slice:
    """This rank's contiguous rows of an ``n``-row global batch (by its
    data index); ``n`` must divide by the data indices (tile or replicate
    a ragged batch first)."""
    w, r = data_size(), data_rank()
    if n % w:
        raise ValueError(f"global batch {n} not divisible by {w} ranks")
    per = n // w
    return slice(r * per, (r + 1) * per)


def local_batch_slice(batch: Dict[str, Any]) -> Dict[str, Any]:
    """A dict batch that every rank holds whole, cut to this rank's rows
    (every rank iterates the same seeded order, so slicing by rank
    partitions the global batch without a message)."""
    sl = process_shard(len(next(iter(batch.values()))))
    return {k: v[sl] for k, v in batch.items()}


# ----------------------------------------------------------- collectives


def reduce_gradients(params) -> None:
    """Replace every ``.grad`` of ``params`` by its mean over the ranks:
    one flat all-reduce a dtype. In a grid a sharded parameter's (one
    with ``tp_dim``) is averaged over its data group, a replicated one's
    over every rank. Nothing happens outside a group."""
    if not is_parallel():
        return
    g = grid()
    by_group: Dict[tuple, list] = {}
    for p in params:
        if p.grad is not None:
            sharded = g is not None and getattr(p, "tp_dim", None) is not None
            by_group.setdefault((sharded, p.grad.dtype), []).append(p.grad)
    for (sharded, _), grads in by_group.items():
        group, w = ((g.data_group, g.n_data) if sharded
                    else (None, world_size()))
        if w == 1:
            continue
        flat = torch.cat([t.reshape(-1) for t in grads])
        dist.all_reduce(flat, group=group)
        flat.div_(w)
        o = 0
        for t in grads:
            t.copy_(flat[o:o + t.numel()].view_as(t))
            o += t.numel()


def mean_over_ranks(losses: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """0-d tensors averaged over the data indices in one all-reduce (each
    rank's is a mean over its rows, and shards are equal, so this is the
    global batch's mean); unchanged outside a group."""
    if not is_parallel() or data_size() == 1:
        return losses
    keys = list(losses)
    wide = torch.float32
    for v in losses.values():
        wide = torch.promote_types(wide, v.dtype)
    flat = torch.stack([losses[k].detach().to(wide) for k in keys])
    dist.all_reduce(flat, group=data_group())
    flat.div_(data_size())
    return {k: flat[i].to(losses[k].dtype) for i, k in enumerate(keys)}


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the data indices, differentiably (the backward
    sums the ranks' gradients into each); ``t`` itself outside a group."""
    if not is_parallel() or data_size() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=data_group()) / data_size()


def _broadcast(t: torch.Tensor, src: int, group) -> None:
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        buf = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.broadcast(buf, src=src, group=group)
        t.copy_(buf)
    else:
        dist.broadcast(t, src=src, group=group)


def broadcast_state(*objs) -> None:
    """Rank 0's tensors of each module (parameters and buffers) and each
    optimizer (its state) copied to every rank, in place; in a grid, the
    tensors of data index 0 to the ranks of the same model index (each
    holds its own slices)."""
    if not is_parallel() or data_size() == 1:
        return
    g = grid()
    src = 0 if g is None else g.model_index  # rank (0, m)
    with torch.no_grad():
        for obj in objs:
            if isinstance(obj, torch.nn.Module):
                tensors = list(obj.state_dict().values())
            else:
                tensors = [v for st in obj.state.values()
                           for v in st.values() if torch.is_tensor(v)]
            for t in tensors:
                _broadcast(t, src, data_group())


def barrier() -> None:
    if is_parallel():
        dist.barrier()


@contextlib.contextmanager
def synced_batchnorm(*models: torch.nn.Module):
    """Train-mode BatchNorm of ``models`` normalized by the global batch's
    statistics inside the block (where this process is in a group whose
    batch is cut into parts: in a grid, more than one data index)."""
    from art_sbir_tpu_torch.models.resnet import BatchNorm2d

    g = grid()
    on = is_parallel() and (g is None or g.n_data > 1)
    bns = [m for model in models for m in model.modules()
           if isinstance(m, BatchNorm2d)] if on else []
    for m in bns:
        m.sync = True
    try:
        yield
    finally:
        for m in bns:
            m.sync = False
