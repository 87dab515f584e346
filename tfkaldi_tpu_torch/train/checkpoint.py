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
state. The decode model ``<savedir>/final.pt`` stays the bare model
``state_dict`` (:func:`tfkaldi_tpu_torch.convert.save_checkpoint`).
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

from tfkaldi_tpu_torch.train.trainer import TrainState


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def save_state(path: str, state: TrainState) -> None:
    """Write ``state`` to ``path`` (a ``.pt`` file), atomically."""
    _atomic_save(
        {
            "step": int(state.step),
            "lr_fact": float(state.lr_fact),
            "adam_t": int(state.adam_t),
            "seed": int(state.seed),
            "model": _cpu(state.model.state_dict()),
            "adam_m": _cpu(state.adam_m),
            "adam_v": _cpu(state.adam_v),
        },
        path,
    )


def restore_state(path: str, template: TrainState) -> TrainState:
    """A new state read from ``path``, on the template's device; the
    template is left as it is."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    model = copy.deepcopy(template.model)
    model.load_state_dict(saved["model"])
    device = next(model.parameters()).device
    return TrainState(
        step=int(saved["step"]),
        lr_fact=float(saved["lr_fact"]),
        model=model,
        adam_m={k: v.to(device) for k, v in saved["adam_m"].items()},
        adam_v={k: v.to(device) for k, v in saved["adam_v"].items()},
        adam_t=int(saved["adam_t"]),
        seed=int(saved["seed"]),
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
    partial state."""
    save_state(path, state)
    tmp = _meta_path(path) + ".tmp"
    with open(tmp, "w") as fid:
        json.dump({"loss": float(loss), "step": int(step)}, fid)
    os.replace(tmp, _meta_path(path))


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
