"""Decoding of the port: likelihood emission (offline and streaming), CTC
text decoding, attention rescoring and beam, the transducer's searches, LM
fusion and the test-set streams (the exports of
``tfkaldi_tpu/decode/__init__.py``)."""

from tfkaldi_tpu_torch.decode.ctc import CTCDecoder, collapse_ctc_path
from tfkaldi_tpu_torch.decode.decoder import Decoder
from tfkaldi_tpu_torch.decode.lm import ArpaLM, DenseFusionTable, FusionScorer
from tfkaldi_tpu_torch.decode.online import (
    OnlineCTCBeamDecoder,
    OnlineCTCDecoder,
    OnlineRecurrentDecoder,
    OnlineSplicedDecoder,
    OnlineWindowedDecoder,
    StreamingTranscriber,
)
from tfkaldi_tpu_torch.decode.seq2seq import CTCRescoreDecoder, Seq2SeqBeamDecoder
from tfkaldi_tpu_torch.decode.transducer import OnlineTransducerDecoder, StreamingTransducerTranscriber, TransducerDecoder
from tfkaldi_tpu_torch.decode.transducer_beam import OnlineTransducerBeamDecoder, TransducerBeamDecoder

__all__ = [
    "ArpaLM",
    "CTCDecoder",
    "CTCRescoreDecoder",
    "Decoder",
    "DenseFusionTable",
    "FusionScorer",
    "OnlineCTCBeamDecoder",
    "OnlineCTCDecoder",
    "OnlineRecurrentDecoder",
    "OnlineSplicedDecoder",
    "OnlineWindowedDecoder",
    "OnlineTransducerBeamDecoder",
    "OnlineTransducerDecoder",
    "Seq2SeqBeamDecoder",
    "StreamingTranscriber",
    "StreamingTransducerTranscriber",
    "TransducerBeamDecoder",
    "TransducerDecoder",
    "collapse_ctc_path",
]
