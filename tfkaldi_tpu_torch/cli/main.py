"""Pipeline entry point of the port: features, GMMs, model training,
likelihoods, WFST decode and WER.

Port of :mod:`tfkaldi_tpu.cli.main` on one device, every step of it, for
the hybrid recipe, the character-CTC recipe, the joint CTC-attention
recipe and the conformer-transducer recipe, with any model family of
``[nnet]`` (``dnn``, ``tdnn``, ``cnn``, ``lstm``, ``gru``, ``transformer``
/ ``conformer``, ``seq2seq``, ``transducer``):

- the four feature steps compute features and CMVN stats on the device;
- ``train_{mono,tri,lda}``, ``align_{mono,tri,lda}`` and
  ``test_{mono,tri,lda}`` run the external Kaldi GMM recipe
  (:mod:`tfkaldi_tpu_torch.kaldi.gmm`: checked subprocesses in
  ``[directories] kaldi_egs``); an alignment step leaves per-job pdf
  archives ``<expdir>/<gmm>/ali/pdf.{j}.gz``;
- hybrid (``loss = cross_entropy``): ``train_nnet`` shuffles the training
  scp, merges the parent GMM's pdf alignments and trains the model →
  ``<expdir>/<nnet name>/final.pt`` and ``prior.npy``; ``test_nnet`` runs
  CMVN + splice + model + softmax ÷ prior → ``<expdir>/<nnet
  name>/decode/likelihoods.ark`` with its ``feats.scp``, then copies the
  parent GMM's ``final.mdl`` and ``graph/`` and the test set's
  ``utt2spk`` and ``text`` beside it, runs Kaldi's
  ``latgen-faster-mapped`` and scoring on the ark
  (:func:`tfkaldi_tpu_torch.kaldi.decode_wfst.decode_wfst`, into
  ``decode/kaldi_decode``) and logs the best WER.
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

Several processes (tfkaldi_tpu/cli/main.py:128-445), started by
``torchrun``: each rank is one process on one device (NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``;
:mod:`tfkaldi_tpu_torch.parallel.multihost`). The feature and GMM steps run
on rank 0, each followed by a barrier; ``train_nnet`` trains on the
``data x model`` grid of ``[nnet] model_parallel`` (default 1) with
``[nnet] batch_size`` the global batch: rank 0 shuffles and writes the
``data`` strided shards of the training scp (``drop_remainder``), and the
ranks of one model group read the same shard, ``batch_size / data``
utterances a batch. ``test_nnet`` decodes a strided shard of the test scp
on every rank with the whole model (``likelihoods.p{i}.ark`` /
``feats.p{i}.scp`` or ``text.p{i}``); after a barrier rank 0 merges the
shards and runs the WFST decode or the scoring.

Usage:
    python -m tfkaldi_tpu_torch.cli.main --config config/config_AURORA4.cfg \\
        --steps dnn_train_features,train_nnet,test_nnet [--device cuda]
    python -m tfkaldi_tpu_torch.cli.main --config ... --steps all
    torchrun --standalone --nproc_per_node 4 -m tfkaldi_tpu_torch.cli.main --config ... \\
        --steps train_nnet,test_nnet [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
from configparser import ConfigParser

from tfkaldi_tpu_torch.kaldi import LdaGmm, MonoGmm, TriGmm, merge_alignments
from tfkaldi_tpu_torch.kaldi.decode_wfst import WfstDecodeOpts, best_wer, decode_wfst
from tfkaldi_tpu_torch.parallel import multihost

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
# the reference's default-on steps (main.py:11-25; tfkaldi_tpu/cli/main.py:40-54)
DEFAULT_STEPS = [
    "gmm_train_features",
    "dnn_train_features",
    "dnn_test_features",
    "train_mono",
    "align_mono",
    "train_tri",
    "align_tri",
    "train_lda",
    "align_lda",
    "train_nnet",
    "test_nnet",
]


def resolve_steps(spec: str) -> set[str]:
    """``--steps``: ``all``, ``default`` or a comma-separated list
    (tfkaldi_tpu/cli/main.py:160-169). Raises ``ValueError`` naming any
    unknown step."""
    if spec == "all":
        return set(STEPS)
    if spec == "default":
        return set(DEFAULT_STEPS)
    steps = {s.strip() for s in spec.split(",") if s.strip()}
    unknown = steps - set(STEPS)
    if unknown:
        raise ValueError(f"unknown steps: {','.join(sorted(unknown))}")
    return steps


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


def merge_shards(out_path: str, shard_paths: list) -> None:
    """Concatenate the ranks' shard files into one output (rank 0)."""
    with open(out_path, "w") as fout:
        for p in shard_paths:
            with open(p) as fin:
                fout.write(fin.read())


def train_nnet(config, nnet, coder, num_labels: int) -> None:
    """The ``train_nnet`` step (tfkaldi_tpu/cli/main.py:253-369): pdf
    alignments for the hybrid recipe, the featdir's ``text`` through
    ``coder`` for the text-target ones. The batches come from the native
    bulk loader (``BulkAlignmentBatchSource`` / ``BulkTextBatchSource``)
    when ``[nnet] native_loader`` is not ``False`` and the native library
    loads, else from the Python dispenser, as the JAX CLI picks them
    (main.py:299-365). Under a process group rank 0 shuffles and writes the
    grid's ``data`` shards of the scp, and each rank reads shard ``rank //
    model_parallel`` with ``batch_size / data`` utterances a batch."""
    from tfkaldi_tpu_torch.data.bulk_loader import BulkAlignmentBatchSource, BulkTextBatchSource
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser, TextBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.frontend.prepare_data import shuffle_examples
    from tfkaldi_tpu_torch.io import native, read_alignments
    from tfkaldi_tpu_torch.data.sharding import shard_path, shard_scp

    from tfkaldi_tpu_torch.parallel import grid_shape

    rank = multihost.rank()
    batch_size = config.getint("nnet", "batch_size")  # the global batch
    data, model = grid_shape(multihost.world_size(), config.getint("nnet", "model_parallel", fallback=1), batch_size)
    train_featdir = featdir(config, "train", "dnn-features")
    seed = config.getint("nnet", "seed", fallback=0)
    train_scp = os.path.join(train_featdir, "feats_shuffled.scp")
    if rank == 0:
        if config.get("nnet", "starting_step") == "0":
            log.info("------- shuffling examples ----------")
            # keep the validation carve (head of the scp) uniformly sampled
            valid_head = config.getint("nnet", "valid_batches") * batch_size
            shuffle_examples(
                train_featdir, seed=seed,
                length_bands=config.getint("nnet", "shuffle_length_bands", fallback=0),
                valid_head=valid_head,
            )
        for i in range(data if data > 1 else 0):
            # equal shard sizes, so the ranks' batch counts agree before the agreement
            shard_scp(train_scp, num_shards=data, shard_index=i, drop_remainder=True)
    multihost.barrier("shuffle")
    if data > 1:
        train_scp = shard_path(train_scp, data, rank // model)
        batch_size //= data
        log.info("rank %d training on scp shard %s, %d utterances a batch", rank, train_scp, batch_size)
    with open(os.path.join(train_featdir, "maxlength")) as fid:
        max_input_length = int(fid.read())
    cmvn, utt2spk = cmvn_path(config, train_featdir), os.path.join(train_featdir, "utt2spk")
    if coder is None:
        # merge per-job alignments (main.py:139-142)
        ali_dir = os.path.join(config.get("directories", "expdir"), config.get("nnet", "gmm_name"), "ali")
        alifile = os.path.join(ali_dir, "pdf.all.gz")
        if not os.path.isfile(alifile):
            alifile = merge_alignments(ali_dir, config.getint("general", "num_jobs"))
    featreader = None
    if config.get("nnet", "native_loader", fallback="True") != "False" and native.available():
        if coder is not None:
            dispenser = BulkTextBatchSource(
                train_scp, cmvn, utt2spk, nnet.context_width, coder, os.path.join(train_featdir, "text"),
                batch_size, max_input_length=max_input_length,
            )
            log.info("using native bulk data loader (text targets)")
        else:
            dispenser = BulkAlignmentBatchSource(
                train_scp, cmvn, utt2spk, nnet.context_width, read_alignments(alifile), batch_size,
                num_labels=num_labels, max_input_length=max_input_length,
            )
            log.info("using native bulk data loader")
    else:
        log.info("using Python data loader (native unavailable or disabled)")
        featreader = FeatureReader(train_scp, cmvn, utt2spk, nnet.context_width, max_input_length)
        if coder is not None:
            dispenser = TextBatchDispenser(featreader, coder, batch_size, os.path.join(train_featdir, "text"))
        else:
            dispenser = AlignmentBatchDispenser(
                featreader, AlignmentCoder(identity_normalizer, num_labels), batch_size, alifile,
            )
    log.info("------- training neural net ----------")
    try:
        nnet.train(dispenser)
    finally:
        if featreader is not None:
            featreader.close()


# the name the text test_nnet logs its scores under
_LOSS_NAMES = {"ctc": "CTC", "attention": "attention", "rnnt": "transducer"}


def test_text(nnet, coder, featreader, test_featdir: str, decodedir: str) -> None:
    """The text-target ``test_nnet`` (tfkaldi_tpu/cli/main.py:394-426):
    decode to ``<decodedir>/text`` (each rank its shard to ``text.p{i}``,
    merged by rank 0 after a barrier), then, when the test featdir has a
    ``text``, score it in the coder's normalised token space: CER over
    character tokens, WER over the words they spell."""
    from tfkaldi_tpu_torch.utils.wer import char_tokens_to_words, score_text_files

    log.info("------- decoding transcriptions ----------")
    name = _LOSS_NAMES[nnet.loss_type]
    out = os.path.join(decodedir, "text")
    rank, world = multihost.rank(), multihost.world_size()
    nnet.decode_text(featreader, coder, out if world == 1 else f"{out}.p{rank}")
    multihost.barrier("text decode")
    if rank != 0:
        return
    if world > 1:
        merge_shards(out, [f"{out}.p{p}" for p in range(world)])
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
        "--steps", default="default",
        help=f"comma-separated steps, 'all', or 'default' (available: {','.join(STEPS)})",
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
    try:
        steps = resolve_steps(args.steps)
    except ValueError as exc:
        log.error("%s", exc)
        return 1

    # the process group first: under torchrun every rank runs this program
    device, owns_group = multihost.initialize(args.device)
    try:
        return _run(args, config, steps, device)
    finally:
        if owns_group:
            multihost.shutdown()


def _run(args, config, steps: set, device) -> int:
    rank, world = multihost.rank(), multihost.world_size()
    if world > 1:
        log.info("multi-process run: rank %d of %d on %s", rank, world, device)
    if "train_nnet" in steps:  # a grid that cannot form fails before any step runs
        from tfkaldi_tpu_torch.parallel import grid_shape

        grid_shape(world, config.getint("nnet", "model_parallel", fallback=1), config.getint("nnet", "batch_size"))

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
        if rank != 0:
            continue  # the featdirs are written once (barrier below)
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
    multihost.barrier("features")

    # ---- GMM stages (main.py:77-114), in external Kaldi, on rank 0 ----
    for cls, prefix in [(MonoGmm, "mono"), (TriGmm, "tri"), (LdaGmm, "lda")]:
        if rank != 0:
            break
        gmm = cls(config)
        if f"train_{prefix}" in steps:
            log.info("------- training %s GMM ----------", prefix)
            gmm.train()
        if f"align_{prefix}" in steps:
            log.info("------- aligning %s GMM ----------", prefix)
            gmm.align()
        if f"test_{prefix}" in steps:
            log.info("------- testing %s GMM ----------", prefix)
            gmm.test()
    if {s for s in steps if s.startswith(("train_", "align_", "test_")) and "nnet" not in s}:
        multihost.barrier("gmm")

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

    from tfkaldi_tpu_torch.data.sharding import shard_scp

    decodedir = os.path.join(nnet.savedir, "decode")
    os.makedirs(decodedir, exist_ok=True)
    test_featdir = featdir(config, "test", "dnn-features")
    with open(os.path.join(test_featdir, "maxlength")) as fid:
        max_length = int(fid.read())
    # every rank decodes its strided shard of the test set (no drop)
    test_scp = shard_scp(os.path.join(test_featdir, "feats.scp"), num_shards=world, shard_index=rank)
    featreader = FeatureReader(
        test_scp,
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
        suffix = "" if world == 1 else f".p{rank}"
        like_path = os.path.join(decodedir, f"likelihoods{suffix}.ark")
        if os.path.isfile(like_path):
            os.remove(like_path)
        nnet.decode(featreader, ArkWriter(os.path.join(decodedir, f"feats{suffix}.scp"), like_path))
    finally:
        featreader.close()
    log.info("wrote %s", like_path)
    multihost.barrier("likelihoods")
    if rank != 0:
        return 0  # rank 0 merges the scp shards and runs the WFST decode
    if world > 1:
        merge_shards(os.path.join(decodedir, "feats.scp"),
                     [os.path.join(decodedir, f"feats.p{p}.scp") for p in range(world)])
    decode_wfst_step(config, decodedir, test_featdir)
    return 0


def decode_wfst_step(config, decodedir: str, test_featdir: str) -> None:
    """The hybrid ``test_nnet``'s Kaldi half (tfkaldi_tpu/cli/main.py:446-471):
    the parent GMM's ``final.mdl`` and ``graph/`` and the test set's
    ``utt2spk`` and ``text`` into ``decodedir`` beside the likelihood ark,
    then ``latgen-faster-mapped`` and scoring into
    ``decodedir/kaldi_decode``; logs the best WER."""
    log.info("------- decoding testing sets ----------")
    gmm_exp = os.path.join(config.get("directories", "expdir"), config.get("nnet", "gmm_name"))
    shutil.copyfile(os.path.join(gmm_exp, "final.mdl"), os.path.join(decodedir, "final.mdl"))
    graph_dst = os.path.join(decodedir, "graph")
    if not os.path.isdir(graph_dst):
        shutil.copytree(os.path.join(gmm_exp, "graph"), graph_dst)
    for name in ("utt2spk", "text"):
        shutil.copyfile(os.path.join(test_featdir, name), os.path.join(decodedir, name))
    kaldi_decode = os.path.join(decodedir, "kaldi_decode")
    decode_wfst(
        graph_dst, decodedir, kaldi_decode, config.get("directories", "kaldi_egs"),
        WfstDecodeOpts(nj=config.getint("general", "num_jobs"), cmd=config.get("general", "cmd")),
    )
    log.info("best WER: %s", best_wer(kaldi_decode))


if __name__ == "__main__":
    sys.exit(main())
