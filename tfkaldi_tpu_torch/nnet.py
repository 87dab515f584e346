"""Nnet facade of the port: config → model → training and likelihood emission.

Port of :class:`tfkaldi_tpu.nnet.Nnet` on one device for the hybrid
recipe's frame cross-entropy (``loss = cross_entropy``), the character
recipe's CTC (``loss = ctc``, config_AURORA4_ctc.cfg: the model emits the
labels plus a blank, the extra final class; nnet.py:53-57), the joint
CTC-attention recipe (``loss = attention`` with ``model = seq2seq``,
config_AURORA4_attention.cfg) and the conformer-transducer recipe (``loss
= rnnt`` with ``model = transducer``, config_AURORA4_transducer.cfg: the
blank is the extra final class, added by the model), with the model
selector and pairing checks of tfkaldi_tpu/nnet.py:53-141 for every
family of the JAX package: ``model = dnn`` (config_AURORA4.cfg
``[nnet]``), ``tdnn``, ``cnn`` (the splice copies become its input
channels), ``lstm`` and ``gru`` (uni- or bidirectional), ``transformer`` /
``conformer``, ``seq2seq`` and ``transducer``.
:meth:`Nnet.train` runs the training controller, which writes
``<savedir>/final.pt`` and ``<savedir>/prior.npy``; :meth:`Nnet.decode`
reads them back for the likelihood ark (:mod:`tfkaldi_tpu_torch.convert`),
:meth:`Nnet.decode_text` reads ``final.pt`` for a CTC text decode, the
attention model's rescoring decode (``decode_mode = rescoring``) or the
transducer's greedy (``beam_width = 1``) or beam search.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from tfkaldi_tpu_torch.convert import load_checkpoint
from tfkaldi_tpu_torch.data.batching import DeviceBatcher
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.decode.ctc import CTCDecoder
from tfkaldi_tpu_torch.decode.decoder import Decoder
from tfkaldi_tpu_torch.decode.seq2seq import CTCRescoreDecoder
from tfkaldi_tpu_torch.decode.transducer import TransducerDecoder
from tfkaldi_tpu_torch.decode.transducer_beam import TransducerBeamDecoder
from tfkaldi_tpu_torch.device import resolve_device
from tfkaldi_tpu_torch.io import ArkWriter
from tfkaldi_tpu_torch.models import (CNNConfig, DNNConfig, RNNConfig, Seq2SeqConfig, TDNNConfig, TransducerConfig,
                                      TransformerConfig, build_model)
from tfkaldi_tpu_torch.train import NnetTrainOptions, Trainer, TrainerConfig, TrainingController
from tfkaldi_tpu_torch.utils import MetricsLogger

log = logging.getLogger(__name__)

class Nnet:
    """The acoustic model (DNN, TDNN, CNN, LSTM, GRU, transformer /
    conformer, the attention seq2seq or the transducer), configured from
    the ``[nnet]`` section."""

    def __init__(self, conf, input_dim: int, num_labels: int, *, device: str | torch.device = "cuda"):
        """Args:
            conf: configparser object (the full .cfg).
            input_dim: raw feature dimension (pre-splicing).
            num_labels: number of pdf targets, or of the text coder's labels
                for ``loss = ctc`` (the model emits one more: the blank),
                ``loss = attention`` (one more: SOS/EOS) and ``loss = rnnt``
                (one more: the blank).
            device: ``cuda`` (default; raises without a card) or ``cpu``.
        """
        self.conf = dict(conf.items("nnet"))
        self.savedir = os.path.join(conf.get("directories", "expdir"), self.conf["name"])
        self.device = resolve_device(device)
        self.context_width = int(self.conf.get("context_width", 0))
        # spliced input dimension (nnet.py:39-40)
        self.input_dim = input_dim * (2 * self.context_width + 1)
        self.num_labels = num_labels
        self.loss_type = self.conf.get("loss", "cross_entropy")
        model_type = self.conf.get("model", "dnn")
        if self.loss_type not in ("cross_entropy", "ctc", "attention", "rnnt"):
            raise ValueError(f"unknown loss {self.loss_type!r}")
        if (model_type == "transducer") != (self.loss_type == "rnnt"):
            raise ValueError("model = transducer and loss = rnnt go together: the transducer is trained by the "
                             "lattice loss and has no per-frame posteriors for CE/CTC")
        if (model_type == "seq2seq") != (self.loss_type == "attention"):
            raise ValueError("model = seq2seq and loss = attention go together: the encoder-decoder is trained by "
                             "teacher-forced CE over text targets and has no per-frame posteriors")
        output_dim = num_labels + 1 if self.loss_type == "ctc" else num_labels
        self.blank_id = num_labels if self.loss_type in ("ctc", "rnnt") else None
        if model_type != "dnn" and int(self.conf.get("add_layer_period", 0)) > 0:
            raise ValueError("layerwise init (add_layer_period) requires model = dnn")
        if model_type == "seq2seq":
            # sos/eos is the extra final class (models/seq2seq.py)
            config = Seq2SeqConfig.from_config(self.conf, self.input_dim, num_labels)
        elif model_type == "transducer":
            # the blank is the extra final class, added by the model (models/transducer.py)
            config = TransducerConfig.from_config(self.conf, self.input_dim, num_labels)
        elif model_type in ("lstm", "gru"):
            config = RNNConfig.from_config(self.conf, self.input_dim, output_dim)
        elif model_type in ("transformer", "conformer"):
            config = TransformerConfig.from_config(self.conf, self.input_dim, output_dim)
            if model_type == "conformer" and not config.conformer:
                config = dataclasses.replace(config, conformer=True)
            if config.subsample > 1 and self.loss_type != "ctc":
                raise ValueError("subsample > 1 needs loss = ctc (frame-level CE targets require the 1:1 "
                                 "alignment)")
        elif model_type == "tdnn":
            config = TDNNConfig.from_config(self.conf, self.input_dim, output_dim)
        elif model_type == "cnn":
            # the splice copies become the conv's input channels
            config = CNNConfig.from_config(self.conf, self.input_dim, output_dim,
                                           num_channels=2 * self.context_width + 1)
        elif model_type == "dnn":
            config = DNNConfig.from_config(self.conf, self.input_dim, output_dim)
        else:
            raise ValueError(f"unknown model type {model_type!r}")
        self.model = build_model(config)

    def _micro_batches(self, batch_size: int) -> int:
        """Map ``numutterances_per_minibatch`` (microbatch SIZE, -1 = whole
        batch; nnet.py:110-114) to an accumulation COUNT."""
        val = int(self.conf.get("numutterances_per_minibatch", -1))
        if val <= 0 or val >= batch_size:
            return 1
        if batch_size % val != 0:
            raise ValueError(
                f"batch_size {batch_size} not divisible by numutterances_per_minibatch {val}"
            )
        return batch_size // val

    def train(self, dispenser, *, init_state=None):
        """Train the network (nnet.py:156-304, one device). ``init_state``
        (a :class:`~tfkaldi_tpu_torch.train.trainer.TrainState`, e.g. from
        :func:`tfkaldi_tpu_torch.convert.train_state_from_jax`) replaces
        the seeded initialisation. Returns the final state."""
        for key in ("visualise", "specaugment"):
            if str(self.conf.get(key, "False")) == "True":
                raise NotImplementedError(
                    f"{key} = True is not in the port yet (ROADMAP.md, queue 1, slice 8); "
                    "use tfkaldi_tpu.nnet.Nnet.train"
                )
        opts = NnetTrainOptions.from_config(self.conf, self.savedir)
        trainer_cfg = TrainerConfig(
            init_learning_rate=float(self.conf.get("initial_learning_rate", 1e-3)),
            learning_rate_decay=float(self.conf.get("learning_rate_decay", 1)),
            num_steps=int(dispenser.num_batches * opts.num_epochs),
            loss_type=self.loss_type,
            micro_batches=self._micro_batches(opts.batch_size),
            ctc_blank_id=self.blank_id if self.blank_id is not None else 0,
        )
        trainer = Trainer(self.model.config, trainer_cfg, device=self.device)
        metrics = MetricsLogger(os.path.join(self.savedir, "metrics.jsonl"))
        controller = TrainingController(trainer, dispenser, DeviceBatcher(), opts, metrics_hook=metrics)
        try:
            return controller.train(init_state)
        finally:
            log.info("avg training throughput: %.0f frames/sec", metrics.avg_frames_per_sec)
            metrics.close()

    def _load_model(self) -> torch.nn.Module:
        self.model.load_state_dict(load_checkpoint(self.savedir))
        return self.model.to(self.device)

    def load_decoder(self) -> Decoder:
        """Load ``final.pt`` and ``prior.npy`` onto the device (once)."""
        self._load_model()
        prior = np.load(os.path.join(self.savedir, "prior.npy"))
        return Decoder(self.model, prior)

    def load_text_decoder(self, coder) -> CTCDecoder | CTCRescoreDecoder | TransducerDecoder:
        """Load ``final.pt`` onto the device for a text decode: for ``loss =
        ctc`` greedy (``beam_width = 1``) or the prefix beam of that width;
        for ``loss = attention`` with ``decode_mode = rescoring``, CTC n-best
        then attention rescoring (nnet.py:362-377); for ``loss = rnnt`` the
        transducer's beam search when ``beam_width > 1``, else its greedy
        search, at most ``max_symbols_per_frame`` labels a frame
        (nnet.py:400-432)."""
        if self.loss_type not in ("ctc", "attention", "rnnt"):
            raise ValueError("decode_text requires loss = ctc, rnnt or attention")
        if self.conf.get("lm_path", ""):
            raise NotImplementedError(
                "lm_path (LM shallow fusion) is not in the port yet (ROADMAP.md, queue 1, item 15); "
                "use tfkaldi_tpu.nnet.Nnet.decode_text"
            )
        if self.loss_type == "attention":
            mode = self.conf.get("decode_mode", "beam")
            if mode != "rescoring":
                raise NotImplementedError(
                    f"decode_mode = {mode} (the autoregressive attention beam) is not in the port yet "
                    "(ROADMAP.md, queue 1, item 14); use decode_mode = rescoring, or tfkaldi_tpu.nnet.Nnet"
                )
            return CTCRescoreDecoder(
                self._load_model(), coder, beam_width=int(self.conf.get("beam_width", 10)),
                rescore_weight=float(self.conf.get("rescore_weight", 0.5)),
                max_tokens=int(self.conf.get("max_decode_tokens", 100)),
            )
        if self.loss_type == "rnnt":
            beam_width = int(self.conf.get("beam_width", 1))
            max_symbols = int(self.conf.get("max_symbols_per_frame", 4))
            if beam_width > 1:
                return TransducerBeamDecoder(self._load_model(), coder, beam_width=beam_width,
                                             max_symbols_per_frame=max_symbols)
            return TransducerDecoder(self._load_model(), coder, max_symbols_per_frame=max_symbols)
        return CTCDecoder(self._load_model(), coder, self.blank_id,
                          beam_width=int(self.conf.get("beam_width", 1)))

    def decode_text(self, reader: FeatureReader, coder, outfile: str) -> int:
        """Decode a test set to a Kaldi ``text`` file with the CTC decoder,
        the attention rescoring decoder or the transducer's search
        (nnet.py:339-472);
        returns the number of utterances."""
        count = self.load_text_decoder(coder).decode_to_file(
            reader,
            outfile,
            batch_size=int(self.conf.get("decode_batch_size", 16)),
            bucket_multiple=int(self.conf.get("decode_bucket_multiple", 128)),
        )
        log.info("decoded %d utterances", count)
        return count

    def decode(self, reader: FeatureReader, writer: ArkWriter) -> int:
        """Emit prior-normalized log pseudo-likelihoods for a test set
        (nnet.py:246-289); closes ``writer``."""
        if self.loss_type in ("rnnt", "attention"):
            raise ValueError("sequence-transduction models have no per-frame posteriors to emit as "
                             "pseudo-likelihoods; use decode_text")
        decoder = self.load_decoder()
        count = decoder.decode_to_writer(
            reader,
            writer,
            batch_size=int(self.conf.get("decode_batch_size", 16)),
            bucket_multiple=int(self.conf.get("decode_bucket_multiple", 128)),
        )
        writer.close()
        log.info("decoded %d utterances", count)
        return count
