"""Weights carried across from the JAX package, and the port's checkpoint.

:func:`dnn_from_jax` maps the JAX DNN pytree (models/dnn.py:95-128,
``params`` and ``state`` given as numpy arrays) to the ``state_dict`` of
:class:`tfkaldi_tpu_torch.models.DNN`, :func:`tdnn_from_jax` the TDNN's
(the same layout) and :func:`cnn_from_jax` the CNN's (its conv weights
transposed from HWIO to OIHW), and :func:`rnn_from_jax` the JAX
LSTM/GRU pytree (models/rnn.py:100-133) to that of
:class:`~tfkaldi_tpu_torch.models.LSTM` or ``GRU``; the layouts are the
same, so the arrays are copied as they are. :func:`transformer_from_jax`
and :func:`seq2seq_from_jax` map the transformer / conformer encoder
(models/transformer.py:196-285) and the attention encoder-decoder
(models/seq2seq.py:187-264) by their pytree paths joined with dots, the
depthwise conv weight transposed from JAX's ``HIO [k, 1, D]`` to torch's
``[D, 1, k]``; :func:`transducer_from_jax` the transducer
(models/transducer.py:188-219) the same way. :func:`train_state_from_jax`
maps a whole JAX ``TrainState``
(its leaves as numpy) of any of these families onto the port's
:class:`~tfkaldi_tpu_torch.train.trainer.TrainState`. The port's decode
checkpoint is ``<savedir>/final.pt``, beside the JAX package's Orbax
``final/``; Orbax checkpoints are not read (``orbax`` imports JAX).
:func:`jax_param_path` names a port parameter by its JAX pytree path.
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


def tdnn_from_jax(params, state) -> dict[str, torch.Tensor]:
    """JAX TDNN ``(params, state)`` → ``state_dict``: the DNN's pytree
    (models/tdnn.py:129-159), its spliced ``w [n_off·fan_in, H]`` as it is."""
    return dnn_from_jax(params, state)


def cnn_from_jax(params, state) -> dict[str, torch.Tensor]:
    """JAX CNN ``(params, state)`` → ``state_dict`` (models/cnn.py:174-232).

    ``params``: ``{"conv": [{"w" HWIO, "b"[, "beta"]}, ...], "hidden": [...],
    "out": {...}}``, the conv weights transposed to OIHW; ``state``: the
    DNN's keys and the per-layer lists ``bn_conv_mean`` / ``bn_conv_var``
    → ``bn_conv_mean.{l}`` / ``bn_conv_var.{l}``."""
    sd = dnn_from_jax(params, state)
    for name in ("bn_conv_mean", "bn_conv_var"):
        for l, stat in enumerate(state.get(name, ())):
            sd[f"{name}.{l}"] = _tensor(np.asarray(stat, np.float32))
    return sd


def rnn_from_jax(params) -> dict[str, torch.Tensor]:
    """JAX LSTM/GRU ``params`` → ``state_dict``.

    ``params``: ``{"layers": [[{"wx", "wh", "b"}] × directions] × layers,
    "out": {"w", "b"}}`` (the model has no state)."""
    return _param_dict(params)


def _tree_dict(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """A params-shaped pytree of the transformer or the seq2seq model (or
    of its Adam ``m`` / ``v``) → the port's names: dict keys and list
    indices joined by dots, every leaf f32, the depthwise ``w_dw``
    transposed ``[k, 1, D] → [D, 1, k]``."""
    out: dict[str, torch.Tensor] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        name = f"{prefix}{key}"
        if isinstance(value, (dict, list, tuple)):
            out.update(_tree_dict(value, name + "."))
            continue
        a = np.asarray(value, np.float32)
        if key == "w_dw":
            a = a.transpose(2, 1, 0)
        out[name] = _tensor(a)
    return out


def _bn_state(state, prefix: str = "") -> dict[str, torch.Tensor]:
    return {f"{prefix}{name}": _tensor(np.asarray(state[name], np.float32))
            for name in ("bn_conv_mean", "bn_conv_var") if name in state}


def transformer_from_jax(params, state) -> dict[str, torch.Tensor]:
    """JAX transformer / conformer ``(params, state)`` → ``state_dict``:
    ``params`` by path, and the conformer's ``bn_conv_mean`` /
    ``bn_conv_var`` from ``state`` (its ``depth`` is not used by the
    model)."""
    return {**_tree_dict(params), **_bn_state(state)}


def seq2seq_from_jax(params, state) -> dict[str, torch.Tensor]:
    """JAX attention seq2seq ``(params, state)`` → ``state_dict``:
    ``params`` by path (the encoder's under ``enc.``), and the encoder's
    batchnorm statistics from ``state["enc"]``."""
    return {**_tree_dict(params), **_bn_state(state.get("enc", {}), "enc.")}


def transducer_from_jax(params, state) -> dict[str, torch.Tensor]:
    """JAX transducer ``(params, state)`` → ``state_dict``: the encoder by
    :func:`transformer_from_jax` (its batchnorm statistics from
    ``state["enc"]``) or :func:`rnn_from_jax`, the prediction network by
    :func:`rnn_from_jax`, ``embed`` and ``joint.{w,b}`` as they are."""
    enc = params["enc"]
    enc_sd = rnn_from_jax(enc) if "layers" in enc else transformer_from_jax(enc, state.get("enc", {}))
    sd = {f"enc.{k}": v for k, v in enc_sd.items()}
    sd.update({f"pred.{k}": v for k, v in rnn_from_jax(params["pred"]).items()})
    sd["embed"] = _tensor(np.asarray(params["embed"], np.float32))
    for name in ("w", "b"):
        sd[f"joint.{name}"] = _tensor(np.asarray(params["joint"][name], np.float32))
    return sd


def _param_dict(tree) -> dict[str, torch.Tensor]:
    """A params-shaped pytree (params, Adam ``m`` or ``v``) of the DNN or
    TDNN (``hidden``), of the CNN (``conv`` too, HWIO → OIHW) or of an RNN
    (``layers``) → the port's parameter names."""
    out: dict[str, torch.Tensor] = {}
    for l, layer in enumerate(tree.get("conv", ())):
        for name in ("w", "b", "beta"):
            if name in layer:
                a = np.asarray(layer[name], np.float32)
                out[f"conv.{l}.{name}"] = _tensor(a.transpose(3, 2, 0, 1) if name == "w" else a)
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
    port's ``TrainState`` for a ``DNNConfig``, a ``TDNNConfig``, a
    ``CNNConfig``, an ``RNNConfig``, a ``TransformerConfig``, a
    ``Seq2SeqConfig`` or a ``TransducerConfig`` on ``device``; the Adam
    moments map by the parameters' names. The threefry dropout key does not
    carry over: the port's dropout stream is seeded from ``seed``."""
    from tfkaldi_tpu_torch.models import (CNNConfig, DNNConfig, RNNConfig, TDNNConfig, TransducerConfig,
                                          TransformerConfig, build_model)
    from tfkaldi_tpu_torch.train.trainer import TrainState

    model = build_model(config)
    moments = _param_dict
    if isinstance(config, (DNNConfig, TDNNConfig)):
        model.load_state_dict(dnn_from_jax(state.params, state.model_state))
    elif isinstance(config, CNNConfig):
        model.load_state_dict(cnn_from_jax(state.params, state.model_state))
    elif isinstance(config, RNNConfig):
        model.load_state_dict(rnn_from_jax(state.params))
    else:
        load = (transformer_from_jax if isinstance(config, TransformerConfig)
                else transducer_from_jax if isinstance(config, TransducerConfig) else seq2seq_from_jax)
        model.load_state_dict(load(state.params, state.model_state))
        moments = _tree_dict
    model.to(device)
    return TrainState(
        step=int(np.asarray(state.step)),
        lr_fact=float(np.asarray(state.lr_fact)),
        model=model,
        adam_m={k: v.to(device) for k, v in moments(state.adam_m).items()},
        adam_v={k: v.to(device) for k, v in moments(state.adam_v).items()},
        adam_t=int(np.asarray(state.adam_t)),
        seed=int(seed),
    )


def jax_param_path(name: str) -> str:
    """The JAX pytree path (``jax.tree_util.keystr``) of the port's
    parameter ``name`` for every family the functions above map:
    dot-separated parts, a numeric part a list index, any other a dict key
    (``hidden.0.w`` → ``['hidden'][0]['w']``)."""
    return "".join(f"[{part}]" if part.isdigit() else f"[{part!r}]" for part in name.split("."))


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
