"""The process grid and the split rules of the training state.

Port of :mod:`tfkaldi_tpu.parallel.mesh` onto ``torch.distributed``. A torch
rank holds one device, so the JAX ``(data, model)`` device mesh becomes a
grid of ranks: rank ``r`` of the grid's rank list sits at ``(r // model,
r % model)``. Each rank joins two process groups, its column of the grid
(the ``data`` group: the ranks that hold the same parameter block and
different rows of the batch) and its row (the ``model`` group: the ranks
that read the same rows and hold different blocks of the split
parameters).

The split rules follow ``_param_shardings`` (mesh.py:48-103) as written,
by the state's names:

- a top-level ``blocks`` list (the transformer / conformer): Megatron's
  split, ``attn.{wq,wk,wv}`` and ``ffn*.w1`` by columns with their biases,
  ``attn.wo`` and ``ffn*.w2`` by rows, everything else replicated;
- a top-level ``hidden`` stack (the DNN, the TDNN, the CNN's dense stack):
  ``hidden.{l}.w`` by columns with ``b`` and ``beta``, ``out.w`` by rows
  (replicated when there is no dense stack), the CNN's ``conv``
  replicated;
- anything else replicated, the LSTM / GRU, the transducer and the
  attention seq2seq included (their encoders sit under ``enc``).

The batchnorm moving stats ``bn_mean`` / ``bn_var`` ``[L, H]`` split with
their columns (mesh.py:106-139); the conv and conformer stats replicate;
Adam's ``m`` and ``v`` split with their parameters. :func:`shard_state`
keeps a rank's blocks of a whole state, :func:`full_state_dict` gathers them
back, so a checkpoint is the same file at any grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tfkaldi_tpu_torch.parallel.comm import gather_columns
from tfkaldi_tpu_torch.parallel.multihost import HOST_BARRIER_TIMEOUT

_MEGATRON = {"attn": {"wq": 1, "bq": 0, "wk": 1, "bk": 0, "wv": 1, "bv": 0, "wo": 0},
             "ffn": {"w1": 1, "b1": 0, "w2": 0}, "ffn1": {"w1": 1, "b1": 0, "w2": 0}}
_DENSE = {"w": 1, "b": 0, "beta": 0}


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a ``data x model`` grid over ``ranks`` and its
    two groups. Copies of a state share it (``copy.deepcopy`` returns it as
    it is)."""

    data: int
    model: int
    ranks: tuple[int, ...]
    rank: int
    data_group: object
    model_group: object
    host_group: object  # gloo, over ``ranks``: the barriers around the files rank ``ranks[0]`` writes

    def __deepcopy__(self, memo):
        return self

    @property
    def writer(self) -> bool:
        """Whether this rank writes the files of the run (the grid's first
        rank; tfkaldi_tpu/train/checkpoint.py:109)."""
        return self.index == 0

    def barrier(self) -> None:
        """Wait for every rank of the grid (on its gloo host group)."""
        dist.barrier(group=self.host_group)

    @property
    def index(self) -> int:
        return self.ranks.index(self.rank)

    @property
    def data_index(self) -> int:
        return self.index // self.model

    @property
    def model_index(self) -> int:
        return self.index % self.model



def grid_shape(world: int, model_parallel: int, batch_size: int) -> tuple[int, int]:
    """``(data, model)`` of a world of ``world`` ranks with ``model =
    model_parallel`` (at least 1); raises naming the numbers unless the
    world divides over ``model_parallel`` and the global ``batch_size``
    over ``data`` (tfkaldi_tpu/nnet.py:206-251)."""
    model = max(int(model_parallel), 1)
    if world % model:
        raise ValueError(f"world size {world} does not divide over [nnet] model_parallel {model}")
    data = world // model
    if batch_size % data:
        raise ValueError(f"[nnet] batch_size {batch_size} (the global batch) does not divide over the "
                         f"{data} data shards of a {data}x{model} grid of {world} ranks")
    return data, model


def make_mesh(data: int | None = None, model: int = 1, ranks=None) -> Mesh | None:
    """A ``data x model`` grid over ``ranks`` (default: every rank of the
    default process group), ``data`` inferred as ``len(ranks) // model``.
    Every rank of the world must call it, in the same order as the others,
    since each group is created collectively; a rank outside ``ranks`` gets
    None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process group (parallel.multihost.initialize)")
    ranks = tuple(range(dist.get_world_size())) if ranks is None else tuple(int(r) for r in ranks)
    model = int(model)
    if model < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model}")
    if data is None:
        data = len(ranks) // model
    if data * model != len(ranks):
        raise ValueError(f"a {data}x{model} grid does not cover {len(ranks)} ranks (world size "
                         f"{dist.get_world_size()}, model_parallel {model})")
    grid = np.asarray(ranks).reshape(data, model)
    me = dist.get_rank()
    data_group = model_group = None
    for c in range(model):
        group = dist.new_group(grid[:, c].tolist())
        if me in grid[:, c]:
            data_group = group
    for d in range(data):
        group = dist.new_group(grid[d].tolist())
        if me in grid[d]:
            model_group = group
    host_group = dist.new_group(list(ranks), backend="gloo", timeout=HOST_BARRIER_TIMEOUT)
    if me not in ranks:
        return None
    return Mesh(int(data), model, ranks, me, data_group, model_group, host_group)


def split_dims(model: nn.Module) -> dict[str, int]:
    """The state-dict names of ``model`` (parameters and buffers) that are
    split over the model axis, each with the dim it is split on; every other
    name is replicated."""
    names = list(model.state_dict())
    out = {}
    if any(n.startswith("blocks.") for n in names):
        for n in names:
            parts = n.split(".")
            if parts[0] == "blocks" and len(parts) == 4 and parts[3] in _MEGATRON.get(parts[2], {}):
                out[n] = _MEGATRON[parts[2]][parts[3]]
        return out
    if not any(n.startswith("hidden.") for n in names):
        return out
    for n in names:
        parts = n.split(".")
        if parts[0] == "hidden" and len(parts) == 3 and parts[2] in _DENSE:
            out[n] = _DENSE[parts[2]]
        elif n == "out.w":
            out[n] = 0
        elif n in ("bn_mean", "bn_var"):
            out[n] = 1
    return out


def _check_split(model: nn.Module, dims: dict, m: int) -> None:
    heads = getattr(getattr(model, "config", None), "num_heads", None)
    if dims and heads is not None and any(n.startswith("blocks.") for n in dims) and heads % m:
        raise ValueError(f"num_heads {heads} does not divide over model_parallel {m}: the column split "
                         f"keeps whole heads")
    sd = model.state_dict()
    for name, d in dims.items():
        if sd[name].shape[d] % m:
            raise ValueError(f"{name} {tuple(sd[name].shape)}: dim {d} of size {sd[name].shape[d]} does not "
                             f"divide over model_parallel {m}")


def _block(t: torch.Tensor, d: int, mesh: Mesh) -> torch.Tensor:
    size = t.shape[d] // mesh.model
    return t.narrow(d, mesh.model_index * size, size).clone()


def local_state_dict(model: nn.Module, full: dict, mesh: Mesh) -> dict:
    """This rank's blocks of a whole state dict of ``model`` (names as
    :func:`split_dims`)."""
    dims = split_dims(model) if mesh.model > 1 else {}
    return {k: (_block(v, dims[k], mesh) if k in dims else v) for k, v in full.items()}


def full_state_dict(model: nn.Module, mesh: Mesh | None, tensors: dict | None = None) -> dict:
    """The whole tensors of a split model, by gathering the blocks over the
    model group (a collective: every rank of the group calls it), on the
    CPU; ``tensors`` (default: the model's state dict) may be any dict
    keyed by the model's names, such as Adam's slots."""
    tensors = model.state_dict() if tensors is None else tensors
    dims = split_dims(model) if mesh is not None and mesh.model > 1 else {}
    out = {}
    for name, t in tensors.items():
        if name in dims:
            d = dims[name]
            t = gather_columns(t.detach().movedim(d, -1).contiguous(), mesh).movedim(-1, d)
        out[name] = t.detach().to("cpu", copy=True)
    return out


def _set_tensor(model: nn.Module, name: str, value: torch.Tensor) -> None:
    path, _, leaf = name.rpartition(".")
    module = model.get_submodule(path) if path else model
    if leaf in module._parameters:
        module._parameters[leaf] = nn.Parameter(value, requires_grad=module._parameters[leaf].requires_grad)
    else:
        module._buffers[leaf] = value


def state_shardings(state, mesh: Mesh) -> dict[str, int]:
    """The split of ``state`` on ``mesh``: the names of its model and Adam
    tensors that are split, each with its dim (empty at ``model = 1``)."""
    dims = split_dims(state.model) if mesh.model > 1 else {}
    _check_split(state.model, dims, mesh.model)
    return dims


def shard_state(state, mesh: Mesh):
    """Keep this rank's blocks of a whole ``TrainState`` (in place: its
    model's split parameters, moving stats and Adam slots become blocks),
    mark the model as split (``model.tp``) and record the grid on the state
    (``state.mesh``). Returns the state."""
    dims = state_shardings(state, mesh)
    model = state.model
    for name, d in dims.items():
        with torch.no_grad():
            _set_tensor(model, name, _block(model.state_dict()[name], d, mesh))
    for slot in (state.adam_m, state.adam_v):
        for name in list(slot):
            if name in dims:
                slot[name] = _block(slot[name], dims[name], mesh)
    model.tp = mesh if dims else None
    state.mesh = mesh
    return state


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a global batch of ``batch_size`` utterances this rank
    holds: its data index's block of ``batch_size / data`` (the JAX
    ``P("data")``)."""
    if batch_size % mesh.data:
        raise ValueError(f"a batch of {batch_size} does not divide over the {mesh.data} data shards")
    b = batch_size // mesh.data
    return slice(b * mesh.data_index, b * (mesh.data_index + 1))


def shard_batch(batch, mesh: Mesh | None, device=None):
    """This rank's rows of a global ``PaddedBatch`` (its data index's block of
    ``B / data`` utterances; the whole batch without a grid), as tensors on
    ``device`` (default: where
    :func:`~tfkaldi_tpu_torch.parallel.multihost.global_batch_from_local`
    puts a rank's batch). The ranks' blocks concatenate, in data order, to
    the global batch, as the JAX ``shard_batch`` splits it over ``data``."""
    from tfkaldi_tpu_torch.data.batching import PaddedBatch
    from tfkaldi_tpu_torch.parallel.multihost import global_batch_from_local

    if mesh is not None:
        rows = batch_sharding(mesh, batch.inputs.shape[0])
        batch = PaddedBatch(*(a[rows] for a in batch.fields()))
    return global_batch_from_local(batch, device=device)
