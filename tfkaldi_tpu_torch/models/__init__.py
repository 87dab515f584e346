"""Acoustic models of the port: the hybrid recipe's DNN, the recurrent
families (LSTM, GRU), the transformer / conformer encoder, the attention
encoder-decoder and the transducer."""

from tfkaldi_tpu_torch.models.dnn import DNN, DNNConfig
from tfkaldi_tpu_torch.models.rnn import GRU, LSTM, RNNConfig
from tfkaldi_tpu_torch.models.seq2seq import AttentionSeq2Seq, Seq2SeqConfig
from tfkaldi_tpu_torch.models.transducer import Transducer, TransducerConfig
from tfkaldi_tpu_torch.models.transformer import Transformer, TransformerConfig


def build_model(config):
    """The model a config describes: ``DNNConfig`` → :class:`DNN`,
    ``RNNConfig`` → :class:`LSTM` or :class:`GRU` (its ``cell``),
    ``TransformerConfig`` → :class:`Transformer`, ``Seq2SeqConfig`` →
    :class:`AttentionSeq2Seq`, ``TransducerConfig`` → :class:`Transducer`."""
    if isinstance(config, DNNConfig):
        return DNN(config)
    if isinstance(config, RNNConfig):
        return {"lstm": LSTM, "gru": GRU}[config.cell](config)
    if isinstance(config, TransformerConfig):
        return Transformer(config)
    if isinstance(config, Seq2SeqConfig):
        return AttentionSeq2Seq(config)
    if isinstance(config, TransducerConfig):
        return Transducer(config)
    raise TypeError(f"no model for a {type(config).__name__}")


__all__ = ["AttentionSeq2Seq", "DNN", "DNNConfig", "GRU", "LSTM", "RNNConfig", "Seq2SeqConfig", "Transducer",
           "TransducerConfig", "Transformer", "TransformerConfig", "build_model"]
