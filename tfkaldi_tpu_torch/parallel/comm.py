"""The collectives the models and the trainer run under a process grid.

In the JAX package GSPMD inserts these from the shardings
(:mod:`tfkaldi_tpu.parallel.mesh`); here they are written out, each as an
autograd function with its own backward:

- **Rows** (the ``data`` axis). While :func:`data_split` is active, the
  batch statistics of batchnorm (:func:`sum_rows`) are summed over the data
  group, forward and backward, so that they are the global batch's; and
  the random draws of dropout (:func:`keep_mask`) are drawn at the global
  batch's shape and sliced to the rank's own rows, so that they do not
  depend on how the batch is split.
- **Columns** (the ``model`` axis, Megatron's pair). A column-split layer
  reads the whole activation: :func:`gather_columns` all-gathers it, and
  its backward sums the partial cotangents and keeps the rank's block. A
  row-split product returns a partial sum: :func:`reduce_from_model`
  all-reduces it forward and passes the cotangent through backward. The
  replicated input of a column-split block passes through
  :func:`copy_to_model`, whose backward all-reduces the cotangent.

Every rank of a group must reach every collective in the same order; a
rank whose slice of the batch is empty still joins them (its sums are
zeros).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """The data split of the step that runs: the data ``group``, the
    utterances ``rows`` of the global (micro-)batch, and where this rank's
    rows begin in it."""

    group: object
    rows: int
    offset: int


_split: RowSplit | None = None


def row_split() -> RowSplit | None:
    """The active :class:`RowSplit`, or None outside a data-split step."""
    return _split


@contextlib.contextmanager
def data_split(group, rows: int, offset: int):
    """Within the block, batch statistics reduce over ``group`` and dropout
    draws the global batch of ``rows`` utterances, this rank's starting at
    ``offset``."""
    global _split
    saved, _split = _split, RowSplit(group, int(rows), int(offset))
    try:
        yield
    finally:
        _split = saved


class _AllReduce(torch.autograd.Function):
    """Forward: the sum over ``group``. Backward: the sum of the cotangents
    over ``group`` when ``reduce_grad``, else the cotangent as it is."""

    @staticmethod
    def forward(ctx, x, group, reduce_grad: bool):
        ctx.group, ctx.reduce_grad = group, reduce_grad
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


class _Copy(torch.autograd.Function):
    """Forward: the identity. Backward: the sum of the cotangents over
    ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherColumns(torch.autograd.Function):
    """Forward: the ranks' column blocks of ``group`` side by side, in rank
    order. Backward: the cotangents summed over ``group``, this rank's
    block kept."""

    @staticmethod
    def forward(ctx, x, group, size: int, index: int):
        ctx.group, ctx.index, ctx.width = group, index, x.shape[-1]
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(-1, ctx.index * ctx.width, ctx.width).contiguous(), None, None, None


def _unflatten(flat: torch.Tensor, like) -> list[torch.Tensor]:
    out, at = [], 0
    for t in like:
        out.append(flat[at: at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def all_reduce_tensors(tensors, group) -> list[torch.Tensor]:
    """The tensors summed over ``group`` in one all-reduce of one flat f32
    buffer (no autograd)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    return _unflatten(flat, tensors)


def sum_rows(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The tensors summed over the active data group in one collective
    (forward and backward; they are flattened into one f32 buffer); as they
    are outside a data-split step."""
    split = _split
    if split is None:
        return tensors
    flat = torch.cat([t.float().reshape(-1) for t in tensors])
    return tuple(_unflatten(_AllReduce.apply(flat, split.group, True), tensors))


def keep_mask(shape, keep: float, generator, device, *, batch_dim: int = 0, cols=None) -> torch.Tensor:
    """Dropout's keep mask (True with probability ``keep``) of ``shape``,
    whose ``batch_dim`` counts utterances. Outside a data split and with no
    ``cols`` it is one draw of ``shape``. Inside a data split the draw has
    the global batch's utterances on ``batch_dim`` and this rank's rows are
    kept; ``cols = (width, offset)`` draws ``width`` columns on the last
    dim and keeps the rank's block from ``offset``. Every rank of a grid
    thus takes its part of the draw a single process makes for the whole
    batch, and the generator advances the same on all of them."""
    split = _split
    shape = tuple(int(s) for s in shape)
    if split is None and cols is None:
        return torch.rand(shape, generator=generator, device=device) < keep
    full = list(shape)
    if split is not None:
        full[batch_dim] = split.rows
    if cols is not None:
        full[-1] = int(cols[0])
    u = torch.rand(full, generator=generator, device=device)
    if split is not None:
        u = u.narrow(batch_dim, split.offset, shape[batch_dim])
    if cols is not None:
        u = u.narrow(-1, int(cols[1]), shape[-1])
    return u < keep


def gather_columns(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole activation ``[..., C·model]`` from this rank's column block
    ``[..., C]`` (the model group of ``mesh``). An empty block skips the
    collective (the ranks of a model group share their rows, so they skip
    it together) and stays on the autograd graph, so that the backward
    still reaches the layers below and their collectives."""
    if x.numel() == 0:
        return torch.cat([x] * mesh.model, dim=-1)
    return _GatherColumns.apply(x, mesh.model_group, mesh.model, mesh.model_index)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-split product's partial sums added over the model group
    (Megatron's ``g``); the cotangent passes through."""
    if x.numel() == 0:
        return x
    return _AllReduce.apply(x, mesh.model_group, False)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The replicated input of column-split products (Megatron's ``f``): the
    identity forward, the cotangents summed over the model group
    backward."""
    if x.numel() == 0:
        return x
    return _Copy.apply(x, mesh.model_group)
