"""Training checkpoints with ``torch.save``.

Port of :mod:`tfkaldi_tpu.train.checkpoint` (Orbax there). One file holds
the whole :class:`~tfkaldi_tpu_torch.train.trainer.TrainState` (model
``state_dict`` with parameters, batchnorm stats and depth; Adam slots and
counter; step, ``lr_fact`` and the dropout seed), so resume is bit-exact.
Every write goes to a temporary file that ``os.replace`` then moves into
place, so a crash never leaves a torn checkpoint. Saves are synchronous.

Files under ``<savedir>/training/``: ``step{N}.pt`` every ``check_freq``
steps, and the rollback point ``validated.pt`` with its
``validated.meta.json`` sidecar ``{loss, step}``, written only after the
state. Each save runs under a ``train.checkpoint`` ``torch.profiler``
span (a validated save's holds its state's). The decode model
``<savedir>/final.pt`` stays the bare model ``state_dict``
(:func:`tfkaldi_tpu_torch.convert.save_checkpoint`).

On a grid of ranks (``state.mesh``) there is one writer
(tfkaldi_tpu/train/checkpoint.py:109): the split tensors are gathered over
the model group, the grid's first rank writes the same file a single
process writes, and every rank waits at a barrier after it. A restore
reads the whole file on every rank and keeps the rank's blocks, so a
checkpoint written on one grid resumes or decodes on any other.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

from tfkaldi_tpu_torch.parallel.mesh import full_state_dict, local_state_dict
from tfkaldi_tpu_torch.train.trainer import TrainState


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def writes(state: TrainState) -> bool:
    """Whether this process writes the run's files: always alone, on a
    grid only its first rank."""
    return state.mesh is None or state.mesh.writer


def barrier(state: TrainState) -> None:
    """After a write: the grid's ranks wait for the writer (a no-op
    alone)."""
    if state.mesh is not None:
        state.mesh.barrier()


def model_state_dict(state: TrainState) -> dict:
    """The whole model ``state_dict`` on the CPU (gathered over the model
    group on a grid: every rank of it must call this)."""
    return full_state_dict(state.model, state.mesh)


def save_state(path: str, state: TrainState) -> None:
    """Write ``state`` to ``path`` (a ``.pt`` file), atomically; on a grid
    the whole state, by its first rank, then a barrier."""
    with torch.profiler.record_function("train.checkpoint"):
        mesh = state.mesh
        blob = {
            "step": int(state.step),
            "lr_fact": float(state.lr_fact),
            "adam_t": int(state.adam_t),
            "seed": int(state.seed),
            "model": model_state_dict(state),
            "adam_m": full_state_dict(state.model, mesh, state.adam_m) if mesh else _cpu(state.adam_m),
            "adam_v": full_state_dict(state.model, mesh, state.adam_v) if mesh else _cpu(state.adam_v),
        }
        if writes(state):
            _atomic_save(blob, path)
        barrier(state)


def restore_state(path: str, template: TrainState) -> TrainState:
    """A new state read from ``path``, on the template's device and, on a
    grid, split as the template is (this rank's blocks of the whole saved
    state); the template is left as it is."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    model = copy.deepcopy(template.model)
    mesh = template.mesh
    local = (lambda d: d) if mesh is None else (lambda d: local_state_dict(template.model, d, mesh))
    model.load_state_dict(local(saved["model"]))
    device = next(model.parameters()).device
    return TrainState(
        step=int(saved["step"]),
        lr_fact=float(saved["lr_fact"]),
        model=model,
        adam_m={k: v.to(device) for k, v in local(saved["adam_m"]).items()},
        adam_v={k: v.to(device) for k, v in local(saved["adam_v"]).items()},
        adam_t=int(saved["adam_t"]),
        seed=int(saved["seed"]),
        mesh=mesh,
    )


def save_prior(path: str, prior: np.ndarray) -> None:
    """Write ``prior.npy`` atomically (decode must never read a partial
    file)."""
    tmp = path + ".tmp.npy"
    np.save(tmp, prior)
    os.replace(tmp, path)


def _meta_path(path: str) -> str:
    return os.path.splitext(path)[0] + ".meta.json"


def save_validated(path: str, state: TrainState, loss: float, step: int) -> None:
    """Persist the validation rollback point (the reference saves
    ``training/validated`` on every successful validation,
    nnet.py:148-149, 206-207). The loss/step sidecar is written only after
    the state, so a crash mid-save never leaves a sidecar pointing at a
    partial state. On a grid the first rank writes both, then a
    barrier."""
    with torch.profiler.record_function("train.checkpoint"):
        save_state(path, state)
        if writes(state):
            tmp = _meta_path(path) + ".tmp"
            with open(tmp, "w") as fid:
                json.dump({"loss": float(loss), "step": int(step)}, fid)
            os.replace(tmp, _meta_path(path))
        barrier(state)


def load_validated_meta(path: str) -> dict | None:
    """The persisted rollback point's ``{"loss", "step"}`` sidecar, or None
    if no complete validated checkpoint exists."""
    if not (os.path.isfile(path) and os.path.isfile(_meta_path(path))):
        return None
    with open(_meta_path(path)) as fid:
        return json.load(fid)


def device_snapshot(state: TrainState) -> TrainState:
    """An in-memory copy of a state on its device (clones), used for the
    'validated' rollback point while training updates the live state in
    place."""
    return TrainState(
        step=state.step,
        lr_fact=state.lr_fact,
        model=copy.deepcopy(state.model),
        adam_m={k: v.clone() for k, v in state.adam_m.items()},
        adam_v={k: v.clone() for k, v in state.adam_v.items()},
        adam_t=state.adam_t,
        seed=state.seed,
        mesh=state.mesh,
    )


def average_params(params_list: list[dict]) -> dict:
    """Elementwise mean of N same-keyed parameter dicts in f32, each leaf
    cast back to its dtype (checkpoint averaging of the decode model;
    optimizer state and batchnorm stats are not averaged)."""
    if not params_list:
        raise ValueError("average_params needs at least one parameter dict")
    n = float(len(params_list))
    out = {}
    for name, first in params_list[0].items():
        acc = first.detach().to(torch.float32)
        for params in params_list[1:]:
            acc = acc + params[name].detach().to(device=acc.device, dtype=torch.float32)
        out[name] = (acc / n).to(first.dtype)
    return out
