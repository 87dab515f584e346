"""Pipeline entry point of the port: features, model training, likelihoods.

Port of :mod:`tfkaldi_tpu.cli.main` on one device for the hybrid recipe,
the character-CTC recipe, the joint CTC-attention recipe and the
conformer-transducer recipe, with ``model = dnn``, ``lstm``, ``gru``,
``transformer`` / ``conformer``, ``seq2seq`` or ``transducer`` in
``[nnet]``. It runs the four feature steps, ``train_nnet`` and
``test_nnet``:

- hybrid (``loss = cross_entropy``): ``train_nnet`` shuffles the training
  scp, merges the parent GMM's pdf alignments and trains the model →
  ``<expdir>/<nnet name>/final.pt`` and ``prior.npy``; ``test_nnet`` runs
  CMVN + splice + model + softmax ÷ prior → ``<expdir>/<nnet
  name>/decode/likelihoods.ark`` with its ``feats.scp``. The WFST decode
  and WER scoring that follow in the JAX pipeline run in external Kaldi on
  that ark and are not part of this entry point.
- CTC (``loss = ctc``, config_AURORA4_ctc.cfg), joint CTC-attention
  (``loss = attention``, config_AURORA4_attention.cfg) and RNN-T (``loss =
  rnnt``, config_AURORA4_transducer.cfg): the targets are the training
  featdir's ``text``, coded by the text coder's 35 characters (the model
  emits a 36th class, the blank or SOS/EOS); ``test_nnet`` writes the
  decode (CTC greedy or beam; attention rescoring; transducer greedy or
  beam) to
  ``<expdir>/<nnet name>/decode/text``, normalises the test featdir's
  ``text`` into ``text.ref_normalized`` and logs the CER and the word-level
  WER under the loss's name.

The GMM steps are not ported yet and raise; ``python -m
tfkaldi_tpu.cli.main`` runs them.

Usage:
    python -m tfkaldi_tpu_torch.cli.main --config config/config_AURORA4.cfg \\
        --steps dnn_train_features,train_nnet,test_nnet [--device cuda]
"""

from __future__ import annotations

import argparse
import gzip
import logging
import os
import sys
from configparser import ConfigParser

log = logging.getLogger("tfkaldi_tpu_torch")

# the JAX pipeline's steps, in order (tfkaldi_tpu/cli/main.py)
STEPS = [
    "gmm_train_features",
    "dnn_train_features",
    "gmm_test_features",
    "dnn_test_features",
    "train_mono",
    "align_mono",
    "test_mono",
    "train_tri",
    "align_tri",
    "test_tri",
    "train_lda",
    "align_lda",
    "test_lda",
    "train_nnet",
    "test_nnet",
]
PORTED_STEPS = {
    "gmm_train_features",
    "dnn_train_features",
    "gmm_test_features",
    "dnn_test_features",
    "train_nnet",
    "test_nnet",
}


def resolve_labels(config):
    """The label space: ``(text_coder, num_labels)`` (the rule of
    tfkaldi_tpu/cli/main.py:59-93). The text-target losses (ctc, rnnt,
    attention) take their labels from the text coder's alphabet, normalised
    by ``[nnet] normalizer`` (``aurora4`` or the identity); the hybrid
    recipe reads ``num_pdfs`` from the parent GMM's graph and has no coder."""
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer, identity_normalizer

    if config.get("nnet", "loss", fallback="cross_entropy") in ("ctc", "rnnt", "attention"):
        aurora4 = config.get("nnet", "normalizer", fallback="") == "aurora4"
        coder = TextCoder(aurora4_normalizer if aurora4 else identity_normalizer)
        return coder, coder.num_labels
    numpdfs_file = os.path.join(
        config.get("directories", "expdir"), config.get("nnet", "gmm_name"), "graph", "num_pdfs"
    )
    with open(numpdfs_file) as fid:
        return None, int(fid.read().strip())


def cmvn_path(config, featdir: str) -> str | None:
    """CMVN scp for a featdir, honoring ``apply_cmvn = False`` in
    ``[dnn-features]``."""
    if (
        config.has_option("dnn-features", "apply_cmvn")
        and config.get("dnn-features", "apply_cmvn") == "False"
    ):
        return None
    return os.path.join(featdir, "cmvn.scp")


def featdir(config, kind: str, section: str) -> str:
    return os.path.join(config.get("directories", f"{kind}_features"), config.get(section, "name"))


def merge_alignments(ali_dir: str, num_jobs: int) -> str:
    """Concatenate per-job pdf archives into ``pdf.all.gz`` (a copy of
    tfkaldi_tpu/kaldi/gmm.py ``merge_alignments``, replacing the ``cat`` at
    main.py:140-142)."""
    out_path = os.path.join(ali_dir, "pdf.all.gz")
    with gzip.open(out_path, "wt") as out:
        for i in range(1, num_jobs + 1):
            with gzip.open(os.path.join(ali_dir, f"pdf.{i}.gz"), "rt") as part:
                out.write(part.read())
    return out_path


def train_nnet(config, nnet, coder, num_labels: int) -> None:
    """The ``train_nnet`` step (tfkaldi_tpu/cli/main.py:253-369, one host,
    the Python dispenser): pdf alignments for the hybrid recipe, the
    featdir's ``text`` through ``coder`` for the text-target one."""
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser, TextBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.frontend.prepare_data import shuffle_examples

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # started by torchrun on several processes
        raise NotImplementedError(
            "multi-process training is not in the port yet (ROADMAP.md, queue 1, slice 8); "
            "use python -m tfkaldi_tpu.cli.main"
        )
    train_featdir = featdir(config, "train", "dnn-features")
    seed = config.getint("nnet", "seed", fallback=0)
    if config.get("nnet", "starting_step") == "0":
        log.info("------- shuffling examples ----------")
        # keep the validation carve (head of the scp) uniformly sampled
        valid_head = config.getint("nnet", "valid_batches") * config.getint("nnet", "batch_size")
        shuffle_examples(
            train_featdir, seed=seed,
            length_bands=config.getint("nnet", "shuffle_length_bands", fallback=0),
            valid_head=valid_head,
        )
    with open(os.path.join(train_featdir, "maxlength")) as fid:
        max_input_length = int(fid.read())
    featreader = FeatureReader(
        os.path.join(train_featdir, "feats_shuffled.scp"),
        cmvn_path(config, train_featdir),
        os.path.join(train_featdir, "utt2spk"),
        nnet.context_width,
        max_input_length,
    )
    log.info("the native bulk training loader is not in the port yet (ROADMAP.md, queue 1, item 21); "
             "using the Python dispenser")
    batch_size = config.getint("nnet", "batch_size")
    if coder is not None:
        dispenser = TextBatchDispenser(featreader, coder, batch_size, os.path.join(train_featdir, "text"))
    else:
        # merge per-job alignments (main.py:139-142)
        ali_dir = os.path.join(config.get("directories", "expdir"), config.get("nnet", "gmm_name"), "ali")
        alifile = os.path.join(ali_dir, "pdf.all.gz")
        if not os.path.isfile(alifile):
            alifile = merge_alignments(ali_dir, config.getint("general", "num_jobs"))
        dispenser = AlignmentBatchDispenser(
            featreader, AlignmentCoder(identity_normalizer, num_labels), batch_size, alifile,
        )
    log.info("------- training neural net ----------")
    try:
        nnet.train(dispenser)
    finally:
        featreader.close()


# the name the text test_nnet logs its scores under
_LOSS_NAMES = {"ctc": "CTC", "attention": "attention", "rnnt": "transducer"}


def test_text(nnet, coder, featreader, test_featdir: str, decodedir: str) -> None:
    """The text-target ``test_nnet`` (tfkaldi_tpu/cli/main.py:394-426):
    decode to ``<decodedir>/text``, then, when the test featdir has a
    ``text``, score it in the coder's normalised token space: CER over
    character tokens, WER over the words they spell."""
    from tfkaldi_tpu_torch.utils.wer import char_tokens_to_words, score_text_files

    log.info("------- decoding transcriptions ----------")
    name = _LOSS_NAMES[nnet.loss_type]
    out = os.path.join(decodedir, "text")
    nnet.decode_text(featreader, coder, out)
    log.info("wrote %s transcriptions to %s", name, out)
    ref_text = os.path.join(test_featdir, "text")
    if not os.path.isfile(ref_text):
        return
    norm = os.path.join(decodedir, "text.ref_normalized")
    with open(ref_text) as fin, open(norm, "w") as fout:
        for line in fin:
            parts = line.split()
            if parts:
                fout.write(parts[0] + " " + coder.target_normalizer(" ".join(parts[1:]), coder.alphabet) + "\n")
    log.info("%s CER: %s", name, score_text_files(norm, out))
    log.info("%s WER: %s", name, score_text_files(norm, out, transform=char_tokens_to_words))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", required=True, help="path to the .cfg file")
    parser.add_argument(
        "--steps", required=True,
        help=f"comma-separated steps (ported: {','.join(s for s in STEPS if s in PORTED_STEPS)})",
    )
    parser.add_argument("--batch-size", type=int, default=32, help="feature-extraction batch")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)

    config = ConfigParser()
    if not config.read(args.config):
        log.error("cannot read config %s", args.config)
        return 1
    steps = {s.strip() for s in args.steps.split(",") if s.strip()}
    unknown = steps - set(STEPS)
    if unknown:
        log.error("unknown steps: %s", ",".join(sorted(unknown)))
        return 1
    missing = steps - PORTED_STEPS
    if missing:
        raise NotImplementedError(
            f"steps {','.join(s for s in STEPS if s in missing)} are not in the port yet "
            "(ROADMAP.md, queue 1); run them with python -m tfkaldi_tpu.cli.main"
        )

    from tfkaldi_tpu_torch.device import resolve_device

    device = resolve_device(args.device)

    from tfkaldi_tpu_torch.frontend.prepare_data import compute_cmvn, prepare_data

    same_feats = config.get("dnn-features", "name") == config.get("gmm-features", "name")
    # ---- feature preparation (main.py:34-74) ----
    for step, kind, section in [
        ("gmm_train_features", "train", "gmm-features"),
        ("dnn_train_features", "train", "dnn-features"),
        ("gmm_test_features", "test", "gmm-features"),
        ("dnn_test_features", "test", "dnn-features"),
    ]:
        if step not in steps:
            continue
        if section == "dnn-features" and same_feats:
            continue  # identical to the gmm features (main.py:45, 67)
        feat_cfg = dict(config.items(section))
        out = featdir(config, kind, section)
        log.info("------- computing %s %s features ----------", kind, section)
        prepare_data(
            config.get("directories", f"{kind}_data"), out, feat_cfg,
            feat_cfg["type"], feat_cfg["dynamic"],
            batch_size=args.batch_size, device=device,
        )
        log.info("------- computing cmvn stats ----------")
        compute_cmvn(out)

    if not ({"train_nnet", "test_nnet"} & steps):
        return 0

    from tfkaldi_tpu_torch.io import ArkReader, ArkWriter
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.nnet import Nnet

    # feature input dim from the first training utterance (main.py:118-120)
    with ArkReader(os.path.join(featdir(config, "train", "dnn-features"), "feats.scp")) as reader:
        input_dim = reader.read_utt_data(0).shape[1]
    coder, num_labels = resolve_labels(config)
    nnet = Nnet(config, input_dim, num_labels, device=device)
    if "train_nnet" in steps:
        train_nnet(config, nnet, coder, num_labels)
    if "test_nnet" not in steps:
        return 0

    decodedir = os.path.join(nnet.savedir, "decode")
    os.makedirs(decodedir, exist_ok=True)
    test_featdir = featdir(config, "test", "dnn-features")
    with open(os.path.join(test_featdir, "maxlength")) as fid:
        max_length = int(fid.read())
    featreader = FeatureReader(
        os.path.join(test_featdir, "feats.scp"),
        cmvn_path(config, test_featdir),
        os.path.join(test_featdir, "utt2spk"),
        nnet.context_width,
        max_length,
    )
    try:
        if coder is not None:
            test_text(nnet, coder, featreader, test_featdir, decodedir)
            return 0
        log.info("------- computing state pseudo-likelihoods ----------")
        like_path = os.path.join(decodedir, "likelihoods.ark")
        if os.path.isfile(like_path):
            os.remove(like_path)
        nnet.decode(featreader, ArkWriter(os.path.join(decodedir, "feats.scp"), like_path))
    finally:
        featreader.close()
    log.info("wrote %s; the WFST decode runs in external Kaldi (latgen-faster-mapped)", like_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
