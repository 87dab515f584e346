"""Weights carried across from the JAX package, and the port's checkpoint.

:func:`dnn_from_jax` maps the JAX DNN pytree (models/dnn.py:95-128,
``params`` and ``state`` given as numpy arrays) to the ``state_dict`` of
:class:`tfkaldi_tpu_torch.models.DNN`, and :func:`rnn_from_jax` the JAX
LSTM/GRU pytree (models/rnn.py:100-133) to that of
:class:`~tfkaldi_tpu_torch.models.LSTM` or ``GRU``; the layouts are the
same, so the arrays are copied as they are. :func:`train_state_from_jax`
maps a whole JAX ``TrainState`` (its leaves as numpy) of either family onto
the port's :class:`~tfkaldi_tpu_torch.train.trainer.TrainState`. The port's decode
checkpoint is ``<savedir>/final.pt``, beside the JAX package's Orbax
``final/``; Orbax checkpoints are not read (``orbax`` imports JAX).
"""

from __future__ import annotations

import os

import numpy as np
import torch

CHECKPOINT = "final.pt"


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def dnn_from_jax(params, state) -> dict[str, torch.Tensor]:
    """JAX ``(params, state)`` pytrees → DNN ``state_dict``.

    ``params``: ``{"hidden": [{"w", "b"[, "beta"]}, ...], "out": {"w", "b"}}``;
    ``state``: ``{"depth"[, "bn_mean", "bn_var"]}``.
    """
    sd = _param_dict(params)
    sd["depth"] = _tensor(np.asarray(state["depth"], np.int32))
    for name in ("bn_mean", "bn_var"):
        if name in state:
            sd[name] = _tensor(np.asarray(state[name], np.float32))
    return sd


def rnn_from_jax(params) -> dict[str, torch.Tensor]:
    """JAX LSTM/GRU ``params`` → ``state_dict``.

    ``params``: ``{"layers": [[{"wx", "wh", "b"}] × directions] × layers,
    "out": {"w", "b"}}`` (the model has no state)."""
    return _param_dict(params)


def _param_dict(tree) -> dict[str, torch.Tensor]:
    """A params-shaped pytree (params, Adam ``m`` or ``v``) of the DNN
    (``hidden``) or of an RNN (``layers``) → the port's parameter names."""
    out: dict[str, torch.Tensor] = {}
    for l, layer in enumerate(tree.get("hidden", ())):
        for name in ("w", "b", "beta"):
            if name in layer:
                out[f"hidden.{l}.{name}"] = _tensor(np.asarray(layer[name], np.float32))
    for l, dirs in enumerate(tree.get("layers", ())):
        for d, direction in enumerate(dirs):
            for name in ("wx", "wh", "b"):
                out[f"layers.{l}.{d}.{name}"] = _tensor(np.asarray(direction[name], np.float32))
    for name in ("w", "b"):
        out[f"out.{name}"] = _tensor(np.asarray(tree["out"][name], np.float32))
    return out


def train_state_from_jax(state, config, *, seed: int = 0, device: str | torch.device = "cpu"):
    """A JAX ``TrainState`` (any object with the attributes ``params``,
    ``model_state``, ``adam_m``, ``adam_v``, ``adam_t``, ``step`` and
    ``lr_fact``, leaves as numpy arrays; train/trainer.py:63-80) → the
    port's ``TrainState`` for a ``DNNConfig`` or an ``RNNConfig`` on
    ``device``. The threefry dropout key does not carry over: the port's
    dropout stream is seeded from ``seed``."""
    from tfkaldi_tpu_torch.models import DNNConfig, build_model
    from tfkaldi_tpu_torch.train.trainer import TrainState

    model = build_model(config)
    if isinstance(config, DNNConfig):
        model.load_state_dict(dnn_from_jax(state.params, state.model_state))
    else:
        model.load_state_dict(rnn_from_jax(state.params))
    model.to(device)
    return TrainState(
        step=int(np.asarray(state.step)),
        lr_fact=float(np.asarray(state.lr_fact)),
        model=model,
        adam_m={k: v.to(device) for k, v in _param_dict(state.adam_m).items()},
        adam_v={k: v.to(device) for k, v in _param_dict(state.adam_v).items()},
        adam_t=int(np.asarray(state.adam_t)),
        seed=int(seed),
    )


def save_checkpoint(savedir: str, state_dict: dict[str, torch.Tensor]) -> str:
    """Write ``<savedir>/final.pt`` atomically; returns its path."""
    os.makedirs(savedir, exist_ok=True)
    path = os.path.join(savedir, CHECKPOINT)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(savedir: str, device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Read ``<savedir>/final.pt`` (tensors only) onto ``device``."""
    return torch.load(os.path.join(savedir, CHECKPOINT), map_location=device, weights_only=True)
