"""Attention rescoring: the two-pass text decode of the joint CTC-attention
model.

Port of :class:`tfkaldi_tpu.decode.seq2seq.CTCRescoreDecoder`
(decode/seq2seq.py:270-435). Per padded batch of the test set
(:func:`~tfkaldi_tpu_torch.decode.streaming.pick_stream`):

- pass 1: the encoder and the CTC head's ``log_softmax`` on the device,
  one D2H copy of the log-posteriors, then the Python prefix beam
  (:mod:`~tfkaldi_tpu_torch.decode.ctc_beam`) on the host keeps each
  utterance's ``beam_width`` best prefixes and their CTC log-probabilities
  (:func:`~tfkaldi_tpu_torch.decode.ctc_beam.nbest_prefixes`);
- pass 2: one teacher-forced decoder forward over all ``B·N`` hypotheses
  (the token axis padded to a multiple of 8), each scored by the sum of its
  labels' and its EOS's log-probabilities;
- the rerank: ``w·logP_ctc + (1−w)·logP_att``, unfilled slots left at
  ``-inf`` whatever the weights.

The autoregressive ``Seq2SeqBeamDecoder`` (and its LM fusion) is not
ported (ROADMAP.md, items 14-15). :attr:`CTCRescoreDecoder.seconds`
accumulates the host-clock time of pass 1 (to the log-posteriors on the
host), the beam and pass 2 (to the scores on the host); :data:`rescored`
counts the batches and the hypotheses pass 2 scored since the last reset.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.decode.ctc_beam import beam_step, initial_beams, nbest_prefixes
from tfkaldi_tpu_torch.decode.streaming import pick_stream

# batches and hypotheses scored by pass 2 since the last reset
rescored = {"batches": 0, "hypotheses": 0}


class CTCRescoreDecoder:
    """Two-pass decode of an :class:`~tfkaldi_tpu_torch.models.seq2seq.
    AttentionSeq2Seq` trained with ``ctc_weight > 0``, on its device.

    After each :meth:`decode_batch`, ``last_tokens [B, N, L+1]`` (SOS, the
    hypothesis, zero padding), ``last_hyp_lens [B, N]``,
    ``last_ctc_scores`` and ``last_att_scores [B, N]`` hold pass 2's
    inputs and both scores."""

    def __init__(self, model, coder, *, beam_width: int = 10, rescore_weight: float = 0.5,
                 max_tokens: int = 100):
        if model.config.ctc_weight <= 0.0:
            raise ValueError("attention rescoring needs a joint model (ctc_weight > 0)")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.coder = coder
        self.beam = int(beam_width)
        self.w = float(rescore_weight)
        self.max_tokens = int(max_tokens)
        self.seconds = {"pass1": 0.0, "beam": 0.0, "pass2": 0.0}
        self.last_tokens = self.last_hyp_lens = self.last_ctc_scores = self.last_att_scores = None

    def first_pass(self, inputs, lengths) -> tuple[torch.Tensor, torch.Tensor]:
        """``(memory [B, T', D], CTC log-posteriors [B, T', V])`` on the
        device."""
        inputs = torch.as_tensor(inputs, dtype=torch.float32).to(self.device, non_blocking=True)
        with torch.inference_mode():
            memory = self.model.encode(inputs, torch.as_tensor(lengths, dtype=torch.int32))
            return memory, torch.log_softmax(self.model.ctc_logits(memory), dim=-1)

    def attention_scores(self, memory, lengths, tokens: np.ndarray, hyp_lens: np.ndarray) -> np.ndarray:
        """Teacher-forced scores ``[B, N]`` (f32) of ``tokens [B, N, L+1]``
        (SOS first) with ``hyp_lens [B, N]`` labels each: the sum over
        positions ``0..len`` of the log-probability of the next label, and of
        EOS at ``len``, against each row's own ``memory``."""
        model = self.model
        b, n, l1 = tokens.shape
        device = memory.device
        tok = torch.as_tensor(tokens.reshape(b * n, l1)).to(device)
        lens = torch.as_tensor(hyp_lens.reshape(b * n)).to(device)
        pos = torch.arange(l1, device=device)[None, :]
        valid = pos <= lens[:, None]
        with torch.inference_mode():
            mem_valid = model.memory_valid(memory, lengths).repeat_interleave(n, dim=0)
            logits = model.decode_step_logits(tok, valid, memory.repeat_interleave(n, dim=0), mem_valid)
            logp = torch.log_softmax(logits, dim=-1)
            # the targets: the tokens shifted left, EOS at each hypothesis' length
            tgt = torch.cat([tok[:, 1:], torch.zeros_like(tok[:, :1])], dim=1)
            tgt = torch.where(pos == lens[:, None], model.sos_eos_id, tgt)
            lp = torch.gather(logp, 2, tgt[:, :, None].long())[..., 0]
            return torch.sum(lp * valid, dim=1).cpu().numpy().reshape(b, n)

    def decode_batch(self, inputs, lengths) -> list[np.ndarray]:
        """``[B, T, F]`` padded features → list of label-id arrays."""
        model, n_best = self.model, self.beam
        t0 = time.perf_counter()
        memory, logp = self.first_pass(inputs, lengths)
        ctc_logp = logp.cpu().numpy().astype(np.float64)
        enc_lens = np.asarray(model.output_lengths(np.asarray(lengths)))
        t1 = time.perf_counter()
        hyps = []
        for row in range(memory.shape[0]):
            beams = initial_beams()
            for t in range(int(enc_lens[row])):
                beams = beam_step(beams, ctc_logp[row, t], model.sos_eos_id, n_best)
            hyps.append(nbest_prefixes(beams, n_best))
        t2 = time.perf_counter()

        # every hypothesis in one batch; the token axis padded to a multiple of 8
        b = len(hyps)
        l_raw = max(1, min(self.max_tokens, max(len(h[0]) for row in hyps for h in row)))
        l_max = -(-l_raw // 8) * 8
        tokens = np.full((b, n_best, l_max + 1), model.sos_eos_id, np.int32)
        hyp_lens = np.zeros((b, n_best), np.int32)
        ctc_scores = np.full((b, n_best), -np.inf, np.float64)
        for row, row_hyps in enumerate(hyps):
            for k, (prefix, score) in enumerate(row_hyps):
                ids = list(prefix)[:l_max]
                tokens[row, k, 1:1 + len(ids)] = ids
                tokens[row, k, 1 + len(ids):] = 0
                hyp_lens[row, k] = len(ids)
                ctc_scores[row, k] = score
        att = self.attention_scores(memory, lengths, tokens, hyp_lens)
        t3 = time.perf_counter()
        rescored["batches"] += 1
        rescored["hypotheses"] += int(np.isfinite(ctc_scores).sum())
        for part, seconds in (("pass1", t1 - t0), ("beam", t2 - t1), ("pass2", t3 - t2)):
            self.seconds[part] += seconds

        # unfilled slots (rows with fewer than N prefixes) stay -inf
        final = np.where(np.isfinite(ctc_scores), self.w * ctc_scores + (1.0 - self.w) * att, -np.inf)
        self.last_tokens, self.last_hyp_lens = tokens, hyp_lens
        self.last_ctc_scores, self.last_att_scores = ctc_scores, att
        out = []
        for row in range(b):
            k = int(np.argmax(final[row]))
            out.append(tokens[row, k, 1:1 + int(hyp_lens[row, k])].astype(np.int32))
        return out

    def decode_to_file(self, reader: FeatureReader, outfile: str, *, batch_size: int = 16,
                       bucket_multiple: int = 128) -> int:
        """Stream the test set and write a Kaldi ``text`` file
        (``utt_id transcription`` per line). Returns #utterances."""
        count = 0
        with open(outfile, "w") as fid:
            for utt_ids, inputs, lengths in pick_stream(reader)(
                reader, batch_size=batch_size, bucket_multiple=bucket_multiple
            ):
                for utt_id, ids in zip(utt_ids, self.decode_batch(inputs, lengths)):
                    fid.write(f"{utt_id} {self.coder.decode(ids)}\n")
                    count += 1
        return count
