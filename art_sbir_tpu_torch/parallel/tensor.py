"""Tensor parallelism: channel-sharded parameters, Adam moments and
BatchNorm statistics over the ``model`` axis of a ``(data, model)`` grid
of ranks.

Counterpart of ``art_sbir_tpu/parallel/tensor.py``. JAX places every leaf
whose TRAILING dimension divides by the model axis's size sharded on that
dimension (``tp_spec``) and lets GSPMD insert the collectives. The port
runs one process a rank (:mod:`~art_sbir_tpu_torch.parallel.multihost`)
and writes the collectives out:

* **The grid.** ``world = n_data * n_model`` ranks; rank ``r = d * n_model
  + m`` sits at data index ``d`` and model index ``m`` (JAX's row-major
  :func:`mesh_2d`). Batch rows follow ``d``; the ranks of one model group
  (one ``d``) hold the same rows and draw the same random numbers.
* **The rule** (:func:`tp_dim`): the dimension of the port's tensor that
  is JAX's trailing one, where it divides by ``n_model``: a conv's or a
  linear's output channels (dim 0), a bias or a BatchNorm vector (dim 0),
  the LSTM's ``(4H, .)`` gate matrices and biases (dim 0; JAX's ``(in,
  4H)``), the attention pool's positional embedding ``(HW + 1, D)`` (dim
  1), and a transposed conv's INPUT channels (dim 0 of ``(in, out, kh,
  kw)``: JAX keeps that kernel ``(kh, kw, out, in)``, torch's transpose
  layout, ``models/port_weights.py::_conv``). Anything else is
  replicated.
* **Column-parallel layers** (:func:`tensor_parallel`): a sharded conv or
  linear keeps its slice of the weight and bias and computes its slice of
  the output channels from the whole input; the slices are all-gathered
  along the channels (:class:`ModelShard.gather`), so the model's code
  between layers runs unchanged on whole activations. In the backward
  the input's gradient is each rank's partial product with its slice,
  summed over the model group (:class:`ModelShard.copy`).
* **Row-parallel transposed convs**: a transposed conv sharded on its
  input channels takes its slice of the (whole) input
  (:meth:`ModelShard.scatter`) through its rows of the kernel, and the
  partial outputs are summed over the model group
  (:meth:`ModelShard.reduce`); its bias, sharded on the output channels
  where they divide, is gathered and added once
  (``models/pix2pix.py::ConvTranspose2d``).
* **Small sharded leaves**: a BatchNorm's weight, bias and running
  statistics and the positional embedding hold the rank's channels; the
  forward gathers them (a few kilobytes), and a running-statistics update
  writes the rank's slice only. The LSTM's gate products are computed
  column-parallel and gathered before the gates split.
* **Adam's moments** follow their parameters (the optimizer is built on
  the slices), so nothing that scales with a layer's width is held whole.

The activations stay whole (replicated) inside a model group; GSPMD keeps
them channel-sharded instead. That is a difference of layout, not of
semantics: each parameter's gradient and every update equal one
device's. Outside the step the state travels in one device's layout:
:func:`gather_state` and :func:`gather_optimizer_state` all-gather the
slices, :func:`slice_state` and :func:`slice_optimizer_state` cut a whole
state to the rank's slices, so a checkpoint written under tensor
parallelism resumes in one process and the other way round.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from art_sbir_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, MeshSpec

_COLUMN_LAYERS = (nn.Conv2d, nn.Linear)
_LEAF_OWNERS = (nn.BatchNorm2d, nn.LSTM, nn.ConvTranspose2d)


def mesh_2d(n_data: int, n_model: int, devices: Sequence) -> Mesh:
    """A ``(data, model)`` mesh over the first ``n_data * n_model`` of
    ``devices`` (which may repeat a device), row-major: rank ``d *
    n_model + m`` on ``devices[d * n_model + m]``."""
    need = n_data * n_model
    if need > len(devices):
        raise ValueError(f"mesh_2d wants {n_data}x{n_model}={need} devices, "
                         f"only {len(devices)} present")
    mesh = MeshSpec(need, DATA_AXIS).build(list(devices))
    return dataclasses.replace(mesh, n_model=n_model)


# ------------------------------------------------------------ the rule


def tp_dim(module: nn.Module, name: str, tensor: torch.Tensor,
           n_model: int) -> Optional[int]:
    """The dimension of ``module``'s parameter or buffer ``name`` that JAX's
    ``tp_spec`` shards over ``n_model`` ranks (its trailing dimension in
    JAX's layout), or None where it is replicated."""
    if tensor.dim() == 0:
        return None
    if name == "positional_embedding":
        dim = tensor.dim() - 1  # (HW + 1, D) in both layouts
    elif isinstance(module, _COLUMN_LAYERS + _LEAF_OWNERS):
        # (out, ...) and (C,); the LSTM's (4H, in) and (4H,); a transposed
        # conv's (in, out, kh, kw), whose flax kernel is (kh, kw, out, in)
        dim = 0
    else:
        raise ValueError(f"no tensor-parallel rule for {type(module).__name__}"
                         f".{name}")
    return dim if tensor.shape[dim] % n_model == 0 else None


def tp_dims(model: nn.Module, n_model: int) -> Dict[str, int]:
    """Every state-dict entry of ``model`` that :func:`tp_dim` shards, and
    its dimension."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, t in itertools.chain(mod.named_parameters(recurse=False),
                                       mod.named_buffers(recurse=False)):
            d = tp_dim(mod, name, t, n_model)
            if d is not None:
                out[f"{prefix}.{name}" if prefix else name] = d
    return out


# ------------------------------------------------------ the collectives


def _dense(t: torch.Tensor):
    """``t`` as a contiguous tensor, and the permutation back: a
    channels-last map travels as its NHWC view, which is contiguous."""
    if (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last)):
        return t.permute(0, 2, 3, 1), (0, 3, 1, 2)
    return t.contiguous(), None


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place in its model group: the group, its size ``n`` and
    the rank's index ``m`` in it."""

    group: Any
    n: int
    m: int

    def local(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's slice of ``t`` along ``dim``."""
        return t.chunk(self.n, dim)[self.m]

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's slices of ``t`` concatenated along ``dim``, in rank
        order (no gradient; a 16-bit float moves as its bits)."""
        dense, back = _dense(t)
        if back is not None:
            dim = {1: 3, 2: 1, 3: 2}.get(dim % 4, dim)
        if dense.dtype in (torch.bfloat16, torch.float16):
            bits = dense.view(torch.int16)
            parts = [torch.empty_like(bits) for _ in range(self.n)]
            dist.all_gather(parts, bits, group=self.group)
            parts = [p.view(dense.dtype) for p in parts]
        else:
            parts = [torch.empty_like(dense) for _ in range(self.n)]
            dist.all_gather(parts, dense, group=self.group)
        out = torch.cat(parts, dim)
        return out if back is None else out.permute(*back)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group (a new tensor; a 16-bit float
        is summed in float32)."""
        dense, back = _dense(t)
        work = (dense.float() if dense.dtype in (torch.bfloat16,
                                                 torch.float16)
                else dense.clone())
        dist.all_reduce(work, group=self.group)
        work = work.to(t.dtype)
        return work if back is None else work.permute(*back)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """:meth:`all_gather`, differentiable: the backward keeps the
        rank's slice of the (replicated) gradient."""
        return _Gather.apply(t, dim, self)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself; the backward sums the gradient over the group
        (each rank holds its slice's partial gradient of the input)."""
        return _Copy.apply(x, self)

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's slice of the whole ``x`` along ``dim``; the backward
        gathers the slices' gradients into the whole input's."""
        return _Scatter.apply(x, dim, self)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial ``y``; the backward passes the
        (replicated) gradient to each partial."""
        return _Reduce.apply(y, self)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return shard.all_gather(t, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.local(grad, ctx.dim), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.all_reduce(grad), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return shard.local(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.all_gather(grad, ctx.dim), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, shard):
        return shard.all_reduce(y)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def model_shard() -> Optional[ModelShard]:
    """This process's :class:`ModelShard` in the grid
    (``multihost.init_grid``), or None outside one."""
    from art_sbir_tpu_torch.parallel import multihost

    grid = multihost.grid()
    if grid is None:
        return None
    return ModelShard(grid.model_group, grid.n_model, grid.model_index)


# ------------------------------------------------------------ the swap


@dataclasses.dataclass(frozen=True)
class Layout:
    """What :func:`tensor_parallel` did to a model: the shard and the
    sharded state-dict entries with their dimensions."""

    shard: ModelShard
    dims: Dict[str, int]


def layout(model: nn.Module) -> Optional[Layout]:
    """``model``'s :class:`Layout`, or None where it runs whole."""
    return getattr(model, "tp_layout", None)


def tensor_parallel(model: nn.Module, shard: Optional[ModelShard]
                    ) -> nn.Module:
    """Keep the rank's slice of every leaf of ``model`` that :func:`tp_dim`
    shards, in place (the whole model is built first, on every rank, from
    one seed), and make each sharded conv and linear column-parallel (see
    the module docstring). The other modules with sharded leaves get
    ``tp`` (the shard) and ``tp_dims`` (their leaves' dimensions) and use
    them in their own forward: ``models/resnet.py``'s BatchNorm and
    attention pool, ``models/photo2sketch.py``'s decoder step (the LSTM)
    and ``models/pix2pix.py``'s transposed conv. Build the optimizer
    afterwards. ``shard`` None leaves the model whole."""
    if shard is None:
        return model
    dims = tp_dims(model, shard.n)
    for prefix, mod in model.named_modules():
        head = f"{prefix}." if prefix else ""
        own = {k[len(head):]: d for k, d in dims.items()
               if k.startswith(head) and "." not in k[len(head):]}
        if not own:
            continue
        with torch.no_grad():
            for name, d in own.items():
                t = getattr(mod, name)
                piece = shard.local(t.detach(), d).clone()
                if name in mod._parameters:
                    piece = nn.Parameter(piece, t.requires_grad)
                    piece.tp_dim = d
                setattr(mod, name, piece)
        if isinstance(mod, _COLUMN_LAYERS):
            out_dim = -1 if isinstance(mod, nn.Linear) else 1
            mod.register_forward_pre_hook(
                lambda m, args: (shard.copy(args[0]),) + tuple(args[1:]))
            mod.register_forward_hook(
                lambda m, args, out, d=out_dim: shard.gather(out, d))
        else:
            mod.tp, mod.tp_dims = shard, own
    model.tp_layout = Layout(shard, dims)
    return model


def whole(module: nn.Module, *names: str) -> list:
    """``module``'s leaves ``names`` whole: gathered (differentiably) where
    :func:`tensor_parallel` sharded them, else as they are. Sharded
    leaves of one dimension travel in one collective."""
    tp, dims = getattr(module, "tp", None), getattr(module, "tp_dims", {})
    leaves = [getattr(module, n) for n in names]
    todo = [i for i, n in enumerate(names) if tp is not None and n in dims]
    if not todo:
        return leaves
    if all(dims[names[i]] == 0 and leaves[i].dim() == 1 for i in todo):
        # rows of one (k, C) tensor: each leaf comes back contiguous (the
        # CPU's batch_norm takes a strided weight wrongly on a
        # channels-last input)
        full = tp.gather(torch.stack([leaves[i] for i in todo]), 1)
        for j, i in enumerate(todo):
            leaves[i] = full[j]
        return leaves
    for i in todo:
        leaves[i] = tp.gather(leaves[i], dims[names[i]])
    return leaves


# ------------------------------------------ one device's layout, and back


def gather_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state dict in one device's layout: the sharded entries
    all-gathered over the model group (every rank of the group must call
    this); the state dict itself where the model runs whole."""
    sd = model.state_dict()
    lay = layout(model)
    if lay is None:
        return sd
    return {k: lay.shard.all_gather(v, lay.dims[k]) if k in lay.dims else v
            for k, v in sd.items()}


def slice_state(model: nn.Module, sd: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """A state dict in one device's layout cut to this rank's slices of
    ``model``'s sharded entries (``sd`` itself where the model runs
    whole)."""
    lay = layout(model)
    if lay is None:
        return sd
    return {k: lay.shard.local(v, lay.dims[k]) if k in lay.dims else v
            for k, v in sd.items()}


def _param_dims(optimizer: torch.optim.Optimizer) -> list:
    """The sharded dimension (or None) of each parameter of ``optimizer``,
    in its state dict's numbering."""
    return [getattr(p, "tp_dim", None)
            for g in optimizer.param_groups for p in g["params"]]


def _map_moments(sd: Dict[str, Any], dims: list, fn) -> Dict[str, Any]:
    """``sd`` (an optimizer's state dict) with ``fn(tensor, dim)`` applied
    to each per-parameter state tensor of a sharded parameter."""
    state = {}
    for i in sorted(sd["state"]):
        d = dims[i]
        state[i] = {k: fn(v, d) if d is not None and torch.is_tensor(v)
                    and v.dim() else v for k, v in sd["state"][i].items()}
    return {**sd, "state": state}


def gather_optimizer_state(model: nn.Module,
                           optimizer: torch.optim.Optimizer
                           ) -> Dict[str, Any]:
    """The optimizer's state dict in one device's layout (Adam's moments
    of a sharded parameter all-gathered; every rank of the group must
    call this)."""
    sd = optimizer.state_dict()
    lay = layout(model)
    if lay is None:
        return sd
    return _map_moments(sd, _param_dims(optimizer), lay.shard.all_gather)


def slice_optimizer_state(model: nn.Module,
                          optimizer: torch.optim.Optimizer,
                          sd: Dict[str, Any]) -> Dict[str, Any]:
    """An optimizer state dict in one device's layout cut to this rank's
    slices."""
    lay = layout(model)
    if lay is None:
        return sd
    # copies: a view would keep the whole moments alive on every rank
    return _map_moments(sd, _param_dims(optimizer),
                        lambda v, d: lay.shard.local(v, d).clone())


def held_bytes(model: nn.Module,
               optimizer: Optional[torch.optim.Optimizer] = None) -> Dict:
    """Bytes this rank holds: parameters, the optimizer's state and the
    buffers."""
    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    opt = 0 if optimizer is None else sum(
        size(v) for st in optimizer.state.values() for v in st.values()
        if torch.is_tensor(v))
    return {"parameters": sum(size(p) for p in model.parameters()),
            "optimizer": opt,
            "buffers": sum(size(b) for b in model.buffers())}
