"""Acoustic models of the port: the hybrid recipe's DNN and the recurrent
families (LSTM, GRU) under frame cross-entropy."""

from tfkaldi_tpu_torch.models.dnn import DNN, DNNConfig
from tfkaldi_tpu_torch.models.rnn import GRU, LSTM, RNNConfig


def build_model(config):
    """The model a config describes: ``DNNConfig`` → :class:`DNN`,
    ``RNNConfig`` → :class:`LSTM` or :class:`GRU` (its ``cell``)."""
    if isinstance(config, DNNConfig):
        return DNN(config)
    if isinstance(config, RNNConfig):
        return {"lstm": LSTM, "gru": GRU}[config.cell](config)
    raise TypeError(f"no model for a {type(config).__name__}")


__all__ = ["DNN", "DNNConfig", "GRU", "LSTM", "RNNConfig", "build_model"]
