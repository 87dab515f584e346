"""Nnet facade of the port: config → model → training and likelihood emission.

Port of :class:`tfkaldi_tpu.nnet.Nnet` for the hybrid recipe's frame
cross-entropy (``loss = cross_entropy``) on one device, with the model
selector of tfkaldi_tpu/nnet.py:95-141 for ``model = dnn``
(config_AURORA4.cfg ``[nnet]``), ``lstm`` and ``gru`` (uni- or
bidirectional); the other families raise ``NotImplementedError``. :meth:`Nnet.train` runs the training controller, which writes
``<savedir>/final.pt`` and ``<savedir>/prior.npy``; :meth:`Nnet.decode`
reads them back (:mod:`tfkaldi_tpu_torch.convert`).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from tfkaldi_tpu_torch.convert import load_checkpoint
from tfkaldi_tpu_torch.data.batching import DeviceBatcher
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.decode.decoder import Decoder
from tfkaldi_tpu_torch.device import resolve_device
from tfkaldi_tpu_torch.io import ArkWriter
from tfkaldi_tpu_torch.models import DNNConfig, RNNConfig, build_model
from tfkaldi_tpu_torch.train import NnetTrainOptions, Trainer, TrainerConfig, TrainingController
from tfkaldi_tpu_torch.utils import MetricsLogger

log = logging.getLogger(__name__)

# families of the JAX package not in the port yet, and their ROADMAP slice
_UNPORTED = {
    "tdnn": "slice 3, item 9", "cnn": "slice 3, item 9", "transformer": "slice 4",
    "conformer": "slice 4", "transducer": "slice 5", "seq2seq": "slice 6",
}


class Nnet:
    """The acoustic model (DNN, LSTM or GRU), configured from the ``[nnet]``
    section."""

    def __init__(self, conf, input_dim: int, num_labels: int, *, device: str | torch.device = "cuda"):
        """Args:
            conf: configparser object (the full .cfg).
            input_dim: raw feature dimension (pre-splicing).
            num_labels: number of pdf targets.
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
        if self.loss_type != "cross_entropy":
            raise NotImplementedError(
                f"loss = {self.loss_type} is not in the port yet (ROADMAP.md, queue 1, "
                "slices 4-6); use tfkaldi_tpu.nnet.Nnet"
            )
        if model_type in _UNPORTED:
            raise NotImplementedError(
                f"model = {model_type} is not in the port yet (ROADMAP.md, queue 1, "
                f"{_UNPORTED[model_type]}); use tfkaldi_tpu.nnet.Nnet"
            )
        if model_type in ("lstm", "gru"):
            if int(self.conf.get("add_layer_period", 0)) > 0:
                raise ValueError("layerwise init (add_layer_period) requires model = dnn")
            config = RNNConfig.from_config(self.conf, self.input_dim, num_labels)
        elif model_type == "dnn":
            config = DNNConfig.from_config(self.conf, self.input_dim, num_labels)
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
            micro_batches=self._micro_batches(opts.batch_size),
        )
        trainer = Trainer(self.model.config, trainer_cfg, device=self.device)
        metrics = MetricsLogger(os.path.join(self.savedir, "metrics.jsonl"))
        controller = TrainingController(trainer, dispenser, DeviceBatcher(), opts, metrics_hook=metrics)
        try:
            return controller.train(init_state)
        finally:
            log.info("avg training throughput: %.0f frames/sec", metrics.avg_frames_per_sec)
            metrics.close()

    def load_decoder(self) -> Decoder:
        """Load ``final.pt`` and ``prior.npy`` onto the device (once)."""
        self.model.load_state_dict(load_checkpoint(self.savedir))
        self.model.to(self.device)
        prior = np.load(os.path.join(self.savedir, "prior.npy"))
        return Decoder(self.model, prior)

    def decode(self, reader: FeatureReader, writer: ArkWriter) -> int:
        """Emit prior-normalized log pseudo-likelihoods for a test set
        (nnet.py:246-289); closes ``writer``."""
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
