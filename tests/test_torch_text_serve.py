"""The port's spool service for text-target models against the JAX service,
on the CPU.

For each text recipe (character CTC with an ``lm_path`` that the service's
CTC decoder does not read, as in the JAX service; the transducer's beam
fused with the LM; the attention model's autoregressive beam fused with the
LM) at a tiny width: one JAX ``TrainState`` with non-zero output heads,
saved as the JAX package's Orbax ``final/`` and, converted, as the port's
``final.pt``; then the JAX ``DecodeService`` and the port's, each over its
own spool holding a copy of one featdir. The port's job writes the same
``text``, byte for byte, and the same ``DONE`` count; ``cli.serve --once
--device cpu`` writes it too, and matches ``Nnet.decode_text`` where the
service's rules equal the facade's.
"""

import dataclasses
import os
import shutil
from configparser import ConfigParser

import jax
import numpy as np
import pytest

from tests.synthetic import make_featdir
from tfkaldi_tpu.data.target_coder import TextCoder as JaxTextCoder
from tfkaldi_tpu.data.target_normalizers import aurora4_normalizer as jax_aurora4_normalizer
from tfkaldi_tpu.nnet import Nnet as JaxNnet
from tfkaldi_tpu.serve import DecodeService as JaxDecodeService
from tfkaldi_tpu.train import Trainer as JaxTrainer
from tfkaldi_tpu.train import TrainerConfig as JaxTrainerConfig
from tfkaldi_tpu.train import checkpoint as jax_ckpt
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.cli import serve as cli_serve
from tfkaldi_tpu_torch.convert import rnn_from_jax, save_checkpoint, seq2seq_from_jax, transducer_from_jax
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.data.target_coder import TextCoder
from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
from tfkaldi_tpu_torch.decode import ctc
from tfkaldi_tpu_torch.nnet import Nnet
from tfkaldi_tpu_torch.serve import DecodeService

FEAT_DIM = 8
RECIPES = {
    "ctc": {"model": "lstm", "loss": "ctc", "bidirectional": "True", "num_hidden_layers": "1",
            "num_hidden_units": "8", "beam_width": "4"},
    "rnnt": {"model": "transducer", "loss": "rnnt", "enc_type": "lstm", "num_hidden_layers": "1",
             "num_hidden_units": "8", "pred_units": "6", "embed_dim": "4", "joint_units": "8", "beam_width": "3"},
    "attention": {"model": "seq2seq", "loss": "attention", "enc_type": "lstm", "num_hidden_layers": "1",
                  "num_hidden_units": "8", "dec_blocks": "1", "d_model": "8", "num_heads": "2", "ffn_dim": "12",
                  "beam_width": "3", "max_decode_tokens": "12", "length_penalty": "0.4"},
}
CONVERT = {"ctc": lambda p, s: rnn_from_jax(p), "rnnt": transducer_from_jax, "attention": seq2seq_from_jax}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A featdir of 8 utterances and a character trigram from seeded
    transcripts."""
    tmp = tmp_path_factory.mktemp("text_serve")
    featdir, _, _ = make_featdir(tmp, num_speakers=2, utts_per_speaker=4, feat_dim=FEAT_DIM)
    rng = np.random.default_rng(3)
    text = tmp / "train_text"
    text.write_text("".join(f"u{i} {synthetic.transcript(rng, 300)}\n" for i in range(40)))
    arpa = str(tmp / "char3.arpa")
    synthetic.write_char_arpa(arpa, [str(text)])
    return tmp, featdir, arpa


def _config(root, recipe, arpa):
    cfg = ConfigParser()
    cfg["directories"] = {"expdir": os.path.join(root, "exp")}
    cfg["nnet"] = {"name": recipe, "context_width": "0", "normalizer": "aurora4", "lm_path": arpa,
                   "lm_alpha": "0.6", "lm_beta": "0.4", **RECIPES[recipe]}
    return cfg


def _checkpoints(cfg, num_labels):
    """One JAX state with random output heads, saved for both packages."""
    jnet = JaxNnet(cfg, input_dim=FEAT_DIM, num_labels=num_labels)
    state = JaxTrainer(jnet.model, JaxTrainerConfig(loss_type=jnet.loss_type)).init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.params)
    model_state = jax.tree.map(np.asarray, state.model_state)
    rng = np.random.default_rng(1)
    for head in ("out", "joint"):
        if head in params and "w" in params[head]:
            params[head]["w"] = (rng.standard_normal(params[head]["w"].shape) * 2.0).astype(np.float32)
    state = dataclasses.replace(state, params=jax.tree.map(jax.numpy.asarray, params))
    jax_ckpt.save_state(os.path.join(jnet.savedir, "final"), state, block=True)
    save_checkpoint(jnet.savedir, CONVERT[cfg["nnet"]["loss"]](params, model_state))
    return jnet


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_text_service_matches_jax(corpus, tmp_path, recipe):
    _, featdir, arpa = corpus
    cfg = _config(str(tmp_path), recipe, arpa)
    coder = TextCoder(aurora4_normalizer)
    jnet = _checkpoints(cfg, coder.num_labels)
    outs = {}
    for side in ("jax", "port"):
        watch, out = tmp_path / f"{side}_in", tmp_path / f"{side}_out"
        shutil.copytree(featdir, watch / "job0")
        if side == "jax":
            service = JaxDecodeService(jnet, str(watch), str(out), coder=JaxTextCoder(jax_aurora4_normalizer),
                                       batch_size=4)
        else:
            ctc.beam_runs.update(native=0, python=0, fused=0)
            service = DecodeService(Nnet(cfg, FEAT_DIM, coder.num_labels, device="cpu"), str(watch), str(out),
                                    coder=coder, batch_size=4)
        assert service.process_pending() == 1
        assert (out / "job0" / "DONE").read_text() == "8\n"
        outs[side] = (out / "job0" / "text").read_text()
    assert outs["port"] == outs["jax"]
    lines = outs["port"].splitlines()
    assert len(lines) == 8 and sum(len(line.split()) - 1 for line in lines) > 0
    if recipe == "ctc":  # the service's CTC beam reads no LM
        assert ctc.beam_runs["fused"] == 0 and ctc.beam_runs["native"] + ctc.beam_runs["python"] == 2


def test_text_service_needs_a_coder(corpus, tmp_path):
    _, _, arpa = corpus
    cfg = _config(str(tmp_path), "rnnt", arpa)
    with pytest.raises(ValueError, match="target coder"):
        DecodeService(Nnet(cfg, FEAT_DIM, 35, device="cpu"), str(tmp_path / "in"), str(tmp_path / "out"))


@pytest.mark.parametrize("recipe", ["rnnt", "attention"])
def test_cli_serve_text_equals_decode_text(corpus, tmp_path, recipe):
    """``cli.serve --once --device cpu`` on a workspace config: the job's
    ``text`` equals ``Nnet.decode_text``'s for the same config (the fused
    transducer and attention beams read the LM in both)."""
    tmp, featdir, arpa = corpus
    cfg = _config(str(tmp_path), recipe, arpa)
    cfg["directories"]["train_features"] = os.path.dirname(featdir)
    cfg["dnn-features"] = {"name": os.path.basename(featdir)}
    cfg_path = str(tmp_path / "serve.cfg")
    with open(cfg_path, "w") as f:
        cfg.write(f)
    coder = TextCoder(aurora4_normalizer)
    _checkpoints(cfg, coder.num_labels)
    watch, out = tmp_path / "in", tmp_path / "out"
    shutil.copytree(featdir, watch / "job0")
    assert cli_serve.main(["--config", cfg_path, "--watch", str(watch), "--out", str(out), "--once",
                           "--device", "cpu"]) == 0
    want = str(tmp_path / "decode_text")
    reader = FeatureReader(os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"),
                           os.path.join(featdir, "utt2spk"), 0, 0)
    assert Nnet(cfg, FEAT_DIM, coder.num_labels, device="cpu").decode_text(reader, coder, want) == 8
    reader.close()
    assert (out / "job0" / "text").read_text() == open(want).read()
    assert (out / "job0" / "DONE").read_text() == "8\n"
