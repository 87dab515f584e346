"""Persistent decode service over a filesystem spool.

Port of :class:`tfkaldi_tpu.serve.DecodeService` (serve.py:35-175). The
model is loaded once onto the device, then decode jobs are processed as they
arrive.

Job contract: a job is a directory dropped under ``watch_dir`` holding a
featdir (``feats.scp``, ``cmvn.scp`` unless CMVN is disabled, ``utt2spk``).
The service writes ``out_dir/<job>/likelihoods.ark`` with its ``feats.scp``
(the hybrid recipe) or ``out_dir/<job>/text`` (``loss = ctc | rnnt |
attention``: the decoder of :meth:`tfkaldi_tpu_torch.nnet.Nnet.
load_text_decoder`, whose CTC beam reads no ``lm_path`` here, as in the JAX
service) plus a ``DONE`` marker holding the utterance count, and skips
jobs already marked ``DONE`` or ``FAILED``, so it is restart-safe. A job
that raises is quarantined with a ``FAILED`` marker holding the traceback.
"""

from __future__ import annotations

import logging
import os
import time
import traceback

from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.io import ArkWriter

log = logging.getLogger(__name__)


class DecodeService:
    """Model-resident decode worker over a filesystem spool."""

    def __init__(self, nnet, watch_dir: str, out_dir: str, *, coder=None, batch_size: int = 16):
        """``nnet``: a :class:`tfkaldi_tpu_torch.nnet.Nnet`; ``coder``: its
        text coder, required for the text-target losses."""
        self.nnet = nnet
        self.watch_dir = watch_dir
        self.out_dir = out_dir
        self.coder = coder
        self.batch_size = batch_size
        self.text = nnet.loss_type in ("ctc", "rnnt", "attention")
        os.makedirs(watch_dir, exist_ok=True)
        os.makedirs(out_dir, exist_ok=True)
        # weights loaded once
        if self.text:
            if coder is None:
                raise ValueError("text-decode service needs a target coder")
            self._decoder = nnet.load_text_decoder(coder, ctc_lm=False)
        else:
            self._decoder = nnet.load_decoder()

    def _pending_jobs(self) -> list[str]:
        jobs = []
        for name in sorted(os.listdir(self.watch_dir)):
            jobdir = os.path.join(self.watch_dir, name)
            if not os.path.isdir(jobdir):
                continue
            if not os.path.isfile(os.path.join(jobdir, "feats.scp")):
                continue  # not (yet) a complete job
            outdir = os.path.join(self.out_dir, name)
            if os.path.isfile(os.path.join(outdir, "DONE")):
                continue
            if os.path.isfile(os.path.join(outdir, "FAILED")):
                continue  # quarantined: an operator removes the marker to retry
            jobs.append(name)
        return jobs

    def process_job(self, name: str) -> int:
        """Decode one job directory; returns the number of utterances."""
        jobdir = os.path.join(self.watch_dir, name)
        outdir = os.path.join(self.out_dir, name)
        os.makedirs(outdir, exist_ok=True)
        cmvn = os.path.join(jobdir, "cmvn.scp")
        reader = FeatureReader(
            os.path.join(jobdir, "feats.scp"),
            cmvn if os.path.isfile(cmvn) else None,
            os.path.join(jobdir, "utt2spk"),
            self.nnet.context_width,
            0,  # max_input_length is not used by the decode stream
        )
        try:
            if self.text:
                count = self._decoder.decode_to_file(reader, os.path.join(outdir, "text"), batch_size=self.batch_size)
            else:
                ark = os.path.join(outdir, "likelihoods.ark")
                if os.path.isfile(ark):
                    os.remove(ark)
                with ArkWriter(os.path.join(outdir, "feats.scp"), ark) as writer:
                    count = self._decoder.decode_to_writer(reader, writer, batch_size=self.batch_size)
        finally:
            reader.close()
        with open(os.path.join(outdir, "DONE"), "w") as f:
            f.write(f"{count}\n")
        log.info("job %s: decoded %d utterances", name, count)
        return count

    def process_pending(self) -> int:
        """One spool sweep; returns the number of jobs processed. A failing
        job is quarantined instead of stopping the service."""
        done = 0
        for name in self._pending_jobs():
            try:
                self.process_job(name)
                done += 1
            except Exception:  # service boundary: record, quarantine, go on
                log.exception("job %s failed; quarantining", name)
                outdir = os.path.join(self.out_dir, name)
                os.makedirs(outdir, exist_ok=True)
                with open(os.path.join(outdir, "FAILED"), "w") as f:
                    f.write(traceback.format_exc())
        return done

    def run(self, poll_seconds: float = 1.0, stop=lambda: False) -> None:
        """Poll the spool until ``stop()`` returns True."""
        log.info("decode service watching %s", self.watch_dir)
        while not stop():
            if self.process_pending() == 0:
                time.sleep(poll_seconds)
