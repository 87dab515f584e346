"""Seeded synthetic hybrid-recipe workspaces (no Kaldi, no corpus needed).

Lays down what the pipeline reads from disk: Kaldi data dirs of int16 wavs
(``wav.scp``, ``utt2spk``, ``spk2utt``, and a ``text`` of seeded
transcripts, each short enough for CTC on its utterance), a config derived from
``config/config_AURORA4.cfg`` with every directory inside the workspace, the
parent GMM's ``graph/num_pdfs``, and a DNN checkpoint (``final.pt`` +
``prior.npy``) of seeded random weights with non-trivial batchnorm stats.
``chip_smoke.py`` and ``tfkaldi_tpu_torch.profile_serve`` drive the port on
it at full width (:func:`make_workspace`); the tests use it at a small width.

:func:`make_train_workspace` lays down a separate training workspace: a
train and a test corpus, and the parent GMM's pdf alignment
``<expdir>/<gmm_name>/ali/pdf.all.gz`` with one label per frame that the
feature step will produce (``1 + (n − 400) // 160`` frames for ``n``
samples at 16 kHz, snip_edges). :func:`recurrent_nnet` gives the
``[nnet]`` overrides that train the repo's BiLSTM (or a BiGRU of the same
widths) on such a workspace under frame cross-entropy, :func:`ctc_nnet`
the ``[nnet]`` of the character-CTC recipe as written, which trains on the
same workspace's transcripts, :func:`attention_nnet` that of the joint
CTC-attention conformer recipe (whose subsampled CTC head wants sparser
transcripts: ``text_density = 8``, or :func:`retext_featdir` beside
existing features), :func:`transducer_nnet` that of the
conformer-transducer recipe (the same encoder and transcripts),
:func:`tdnn_nnet` and :func:`cnn_nnet` bench.py's TDNN and CNN, and
:func:`random_rnn_pytree` seeded LSTM/GRU weights in the JAX layout, and
:func:`write_char_arpa` a character n-gram ARPA file estimated from a
workspace's transcripts (test data for the LM-fused beams).

Every config :func:`write_config` writes comes with a stub Kaldi egs
(:func:`write_stub_kaldi`): shell scripts and fake binaries in place of
Kaldi's GMM recipe, ``latgen-faster-mapped`` and scoring, so that every
step of ``cli.main`` runs end to end, to a logged WER, without Kaldi.
"""

from __future__ import annotations

import gzip
import math
import os
import shutil
import sys
from collections import Counter
from configparser import ConfigParser

import numpy as np
import scipy.io.wavfile

from tfkaldi_tpu_torch.convert import dnn_from_jax, save_checkpoint
from tfkaldi_tpu_torch.data.target_coder import TextCoder
from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer

RATE = 16000
_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config")
AURORA4_CONFIG = os.path.join(_CONFIG_DIR, "config_AURORA4.cfg")
AURORA4_CTC_CONFIG = os.path.join(_CONFIG_DIR, "config_AURORA4_ctc.cfg")
AURORA4_ATTENTION_CONFIG = os.path.join(_CONFIG_DIR, "config_AURORA4_attention.cfg")
AURORA4_TRANSDUCER_CONFIG = os.path.join(_CONFIG_DIR, "config_AURORA4_transducer.cfg")
# keys of the CTC recipe's [nnet] that belong to its text targets or its
# experiment, not to the network
_CTC_ONLY = ("name", "loss", "normalizer", "beam_width", "gmm_name")
# the words of the synthetic transcripts: WSJ-style upper case, with
# Aurora-4's punctuation words, an apostrophe, a hyphen and a digit (which
# the character normalizer maps to <unk>)
WORDS = (
    "THE", "OF", "TO", "A", "IN", "AND", "MARKET", "SHARES", "PRICES", "COMPANY", "SAID", "YEAR",
    "PERCENT", "TRADING", "BANK", "RATES", "STOCK", "NEW", "YORK", "WEEK", "ANALYSTS", "INVESTORS",
    "O'BRIEN", "X-RAY", "B2B", ",COMMA", ".PERIOD", "\"DOUBLE-QUOTE", "-HYPHEN", "<NOISE>",
)
_TEXT_CODER = TextCoder(aurora4_normalizer)


def transcript(rng: np.random.Generator, num_frames: int, density: int = 3) -> str:
    """A seeded transcript whose normalised form (the CTC targets) is at
    most ``num_frames // density`` tokens: words are drawn from
    :data:`WORDS` until the next one would take it past a length drawn
    between half and all of that budget; ``<NOISE>`` alone (normalised to
    ``<sos> <eos>``) where the first word drawn does not fit. Density 3
    suits a CTC head on every frame; a head on every fourth frame (the
    attention recipe's ``subsample = 4``) needs 8, where even a transcript
    of repeated labels fits (real speech has about 12-15 characters a
    second at 100 frames a second)."""
    budget = num_frames // density
    want = int(rng.integers(budget // 2, budget + 1))
    words: list[str] = []
    while True:
        word = WORDS[int(rng.integers(len(WORDS)))]
        if _TEXT_CODER.encode(" ".join(words + [word])).size > want:
            break
        words.append(word)
    return " ".join(words) or "<NOISE>"


def make_wav_datadir(
    datadir: str,
    *,
    num_speakers: int,
    utts_per_speaker: int,
    min_seconds: float,
    max_seconds: float,
    seed: int,
    prefix: str = "",
    text_density: int = 3,
) -> list[str]:
    """Write a Kaldi data dir of noise-like int16 wavs and their seeded
    transcripts (:func:`transcript` at ``text_density``, from a stream of
    their own, so the wavs are those of ``seed`` alone); returns the utt
    ids in wav.scp order."""
    rng = np.random.default_rng(seed)
    text_rng = np.random.default_rng([seed, 1])
    wavdir = os.path.join(datadir, "wavs")
    os.makedirs(wavdir, exist_ok=True)
    utts, texts = [], []
    for s in range(num_speakers):
        for u in range(utts_per_speaker):
            utt = f"{prefix}spk{s}_utt{u:03d}"
            n = int(rng.integers(int(min_seconds * RATE), int(max_seconds * RATE) + 1))
            # speaker-dependent gain so per-speaker CMVN has work to do
            sig = rng.standard_normal(n) * (2000.0 + 1500.0 * s)
            sig = np.clip(sig, -32768, 32767).astype(np.int16)
            scipy.io.wavfile.write(os.path.join(wavdir, f"{utt}.wav"), RATE, sig)
            utts.append(utt)
            texts.append(transcript(text_rng, num_frames(n), text_density))
    with open(os.path.join(datadir, "wav.scp"), "w") as f:
        for utt in utts:
            f.write(f"{utt} {os.path.join(wavdir, utt + '.wav')}\n")
    with open(os.path.join(datadir, "utt2spk"), "w") as f:
        for utt in utts:
            f.write(f"{utt} {utt.split('_')[0]}\n")
    with open(os.path.join(datadir, "spk2utt"), "w") as f:
        for s in range(num_speakers):
            spk = f"{prefix}spk{s}"
            f.write(f"{spk} {' '.join(u for u in utts if u.split('_')[0] == spk)}\n")
    with open(os.path.join(datadir, "text"), "w") as f:
        for utt, text in zip(utts, texts):
            f.write(f"{utt} {text}\n")
    return utts


def write_parent_gmm(gmm_exp: str, num_pdfs: int) -> None:
    """What a trained parent GMM leaves in ``gmm_exp`` for the hybrid
    recipe's nnet steps: ``final.mdl`` and ``graph/`` (``num_pdfs``,
    ``HCLG.fst``, ``words.txt``), as the stub egs writes them."""
    graph = os.path.join(gmm_exp, "graph")
    os.makedirs(graph, exist_ok=True)
    for name, text in (("num_pdfs", f"{num_pdfs}\n"), ("HCLG.fst", "stub HCLG\n"), ("words.txt", "<eps> 0\nA 1\n")):
        with open(os.path.join(graph, name), "w") as f:
            f.write(text)
    with open(os.path.join(gmm_exp, "final.mdl"), "w") as f:
        f.write("stub final.mdl of the parent GMM\n")


def write_config(root: str, *, num_pdfs: int, nnet: dict | None = None, dnn_features: dict | None = None) -> str:
    """``config/config_AURORA4.cfg`` with its directories moved under
    ``root``, ``[nnet]``/``[dnn-features]`` keys overridden, a stub Kaldi
    egs under ``kaldi_egs`` (:func:`write_stub_kaldi`; ``[general] cmd`` is
    its ``run.pl``) and the parent GMM's ``final.mdl`` and ``graph/``
    (``num_pdfs``, ``HCLG.fst``, ``words.txt``) written, as its training
    would leave them; returns the config path."""
    config = ConfigParser()
    if not config.read(AURORA4_CONFIG):
        raise FileNotFoundError(AURORA4_CONFIG)
    for key in ("train_data", "test_data", "train_features", "test_features",
                "language", "language_test", "expdir", "kaldi_egs"):
        config.set("directories", key, os.path.join(root, key))
    for section, over in (("nnet", nnet), ("dnn-features", dnn_features)):
        for key, value in (over or {}).items():
            config.set(section, key, str(value))
    config.set("general", "cmd", write_stub_kaldi(config.get("directories", "kaldi_egs"), num_pdfs))
    write_parent_gmm(os.path.join(root, "expdir", config.get("nnet", "gmm_name")), num_pdfs)
    path = os.path.join(root, "config.cfg")
    with open(path, "w") as f:
        config.write(f)
    return path


# the stub scorer's results: local/score.sh writes both, best_wer picks the first
STUB_WERS = {"wer_10": "%WER 5.55 [ 55 / 990, 5 ins, 20 del, 30 sub ]",
             "wer_11": "%WER 6.66 [ 66 / 990, 6 ins, 25 del, 35 sub ]"}

# bash bodies of the stub Kaldi egs, by path under the egs dir; {bindir},
# {num_pdfs}, {python}, {helper} and {wer_*} are filled in by write_stub_kaldi
_STUBS = {
    # Kaldi's job runner: JOB=1:N over the command, one log per job, the
    # arguments re-quoted as utils/run.pl does, the fake binaries on PATH
    "fakebin/run.pl": """export PATH="{bindir}:$PATH"
while [[ "$1" == --* ]]; do shift 2; done
spec=$1; shift
log=$1; shift
n=${{spec##*:}}
for j in $(seq 1 "$n"); do
  thislog=${{log//JOB/$j}}
  mkdir -p "$(dirname "$thislog")"
  cmd=$(printf '%q ' "$@")
  cmd=${{cmd//JOB/$j}}
  bash -c "$cmd" > "$thislog" 2>&1
done
""",
    # args: [--opt=value]... model HCLG.fst 'ark,s,cs:copy-feats scp:S ark:- |' 'ark:|gzip -c > L'
    "fakebin/latgen-faster-mapped": """opts=()
while [[ "$1" == --* ]]; do opts+=("$1"); shift; done
model=$1; fst=$2; feats=$3; lats=$4
test -f "$model" && test -f "$fst"
scp=${{feats#*copy-feats scp:}}; scp=${{scp%% *}}
test -f "$scp"
n=$(wc -l < "$scp")
echo "latgen-faster-mapped ${{opts[*]}} $model $fst"
echo "features: $scp ($n utterances)"
echo "lattices of $n utterances" | bash -c "${{lats#ark:|}}"
""",
    "fakebin/copy-feats": """echo feats
""",
    # transition-ids -> pdf-ids by halving each id (args: final.mdl ark:- ark,t:-)
    "fakebin/ali-to-pdf": """awk '{{ printf "%s", $1; for (i=2; i<=NF; i++) printf " %d", int($i/2); print "" }}'
""",
    "steps/train_mono.sh": """while [[ "$1" == --* ]]; do shift 2; done
expdir=${{!#}}
mkdir -p "$expdir"
echo "stub final.mdl of $(basename "$0")" > "$expdir/final.mdl"
""",
    # args: --nj N --cmd C --config F featdir lang srcdir alidir
    "steps/align_si.sh": """nj=1
while [[ "$1" == --* ]]; do if [[ "$1" == --nj ]]; then nj=$2; fi; shift 2; done
featdir=$1; srcdir=$3; alidir=$4
mkdir -p "$alidir"
cp "$srcdir/final.mdl" "$alidir/final.mdl"
{python} {helper} "$featdir" "$alidir" "$nj"
""",
    # args: --cmd C --nj N graphdir data decodedir
    "steps/decode.sh": """while [[ "$1" == --* ]]; do shift 2; done
graph=$1; data=$2; dir=$3
test -f "$graph/HCLG.fst" && test -f "$data/feats.scp"
mkdir -p "$dir"
echo "{wer_10}" > "$dir/wer_10"
echo "decoded $(wc -l < "$data/feats.scp") utterances"
""",
    "utils/mkgraph.sh": """while [[ "$1" == --* ]]; do shift; done
graph=${{!#}}
mkdir -p "$graph"
echo {num_pdfs} > "$graph/num_pdfs"
echo "stub HCLG" > "$graph/HCLG.fst"
printf '<eps> 0\\nA 1\\n' > "$graph/words.txt"
""",
    "utils/split_data.sh": """data=$1; nj=$2
for j in $(seq 1 "$nj"); do
  mkdir -p "$data/split$nj/$j"
  cp "$data/feats.scp" "$data/split$nj/$j/feats.scp"
done
""",
    "local/score.sh": """while [[ "$1" == --* ]]; do shift 2; done
decode_dir=${{!#}}
echo "{wer_10}" > "$decode_dir/wer_10"
echo "{wer_11}" > "$decode_dir/wer_11"
""",
}
_STUBS["steps/train_deltas.sh"] = _STUBS["steps/train_lda_mllt.sh"] = _STUBS["steps/train_mono.sh"]

# the align stub's helper: frame-length-matched transition-id alignments
# (2 x a seeded pdf) per job, read from the featdir with the port's ArkReader
_ALIGN_HELPER = """import gzip, os, sys
sys.path.insert(0, {root!r})
import numpy as np
from tfkaldi_tpu_torch.io import ArkReader

featdir, alidir, nj = sys.argv[1], sys.argv[2], int(sys.argv[3])
reader = ArkReader(os.path.join(featdir, "feats.scp"))
rng = np.random.default_rng(0)
utts = reader.utt_ids
chunk = -(-len(utts) // nj)
for j in range(nj):
    with gzip.open(os.path.join(alidir, f"ali.{{j + 1}}.gz"), "wt") as f:
        for utt in utts[j * chunk : (j + 1) * chunk]:
            ali = 2 * rng.integers(0, {num_pdfs}, size=reader.read_utt(utt).shape[0])
            f.write(utt + " " + " ".join(map(str, ali)) + "\\n")
"""


def write_stub_kaldi(egs: str, num_pdfs: int) -> str:
    """Lay down a stub Kaldi egs dir at ``egs``: ``steps/{train_mono,
    train_deltas,train_lda_mllt,align_si,decode}.sh``,
    ``utils/{mkgraph,split_data}.sh``, ``local/score.sh`` and the binaries
    ``run.pl``, ``latgen-faster-mapped``, ``copy-feats`` and ``ali-to-pdf``
    under ``fakebin/``. They check what they are handed and leave what the
    next step reads: a ``final.mdl``, a graph of ``num_pdfs`` pdfs,
    transition-id alignments of the featdir's frame counts, the lattice
    decode's logs (its options, model, graph and split ``feats.scp``) and
    ``wer_*`` files (:data:`STUB_WERS`). ``run.pl`` puts ``fakebin/`` on
    ``PATH`` for the commands it runs; ``ali-to-pdf`` is called outside it,
    so an alignment step needs ``fakebin/`` on the caller's ``PATH``.
    Returns the absolute path of ``run.pl``."""
    egs = os.path.abspath(egs)
    bindir = os.path.join(egs, "fakebin")
    helper = os.path.join(egs, "local", "emit_ali.py")
    os.makedirs(os.path.dirname(helper), exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(helper, "w") as f:
        f.write(_ALIGN_HELPER.format(root=root, num_pdfs=num_pdfs))
    fill = dict(bindir=bindir, num_pdfs=num_pdfs, python=sys.executable, helper=helper, **STUB_WERS)
    for name, body in _STUBS.items():
        path = os.path.join(egs, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("#!/bin/bash\nset -e\n" + body.format(**fill))
        os.chmod(path, 0o755)
    return os.path.join(bindir, "run.pl")


def random_dnn_pytree(
    input_dim: int, hidden_units: int, hidden_layers: int, num_labels: int, *, seed: int
) -> tuple[dict, dict]:
    """Seeded DNN weights in the JAX package's pytree layout (as numpy):
    N(0, 1/sqrt(fan_in)) weights, small biases, batchnorm ``beta`` and
    moving stats away from the identity, and a non-zero output layer."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return np.asarray(a, np.float32)

    hidden = []
    fan_in = input_dim
    for _ in range(hidden_layers):
        hidden.append({
            "w": f32(rng.standard_normal((fan_in, hidden_units)) / np.sqrt(fan_in)),
            "b": f32(rng.standard_normal(hidden_units) * 0.1),
            "beta": f32(rng.standard_normal(hidden_units) * 0.1),
        })
        fan_in = hidden_units
    params = {
        "hidden": hidden,
        "out": {
            "w": f32(rng.standard_normal((hidden_units, num_labels)) / np.sqrt(hidden_units)),
            "b": f32(rng.standard_normal(num_labels) * 0.1),
        },
    }
    state = {
        "depth": np.asarray(0, np.int32),
        "bn_mean": f32(rng.standard_normal((hidden_layers, hidden_units)) * 0.2),
        "bn_var": f32(rng.uniform(0.5, 2.0, (hidden_layers, hidden_units))),
    }
    return params, state


def recurrent_nnet(cell: str = "lstm") -> dict:
    """``[nnet]`` overrides for the repo's recurrent network under the
    hybrid recipe's frame cross-entropy: the ``[nnet]`` of
    ``config_AURORA4_ctc.cfg`` (2 x 512 bidirectional, ``context_width =
    2``, bf16, batch 128, dropout 0.8) with its CTC-only keys dropped,
    ``model = cell`` (lstm or gru) and the name ``bi{cell}_512_2_ce``. Laid
    over ``config_AURORA4.cfg`` it keeps that recipe's ``gmm_name``, so it
    trains on the parent GMM's pdf alignments."""
    config = ConfigParser()
    if not config.read(AURORA4_CTC_CONFIG):
        raise FileNotFoundError(AURORA4_CTC_CONFIG)
    nnet = {k: v for k, v in config.items("nnet") if k not in _CTC_ONLY}
    nnet.update(model=cell, name=f"bi{cell}_512_2_ce")
    return nnet


def ctc_nnet() -> dict:
    """The ``[nnet]`` of ``config_AURORA4_ctc.cfg`` exactly as written:
    character CTC (``loss = ctc``, ``normalizer = aurora4``, ``beam_width =
    16``) on a 2 x 512 BiLSTM in bf16, batch 128. It sets every key of
    ``config_AURORA4.cfg``'s ``[nnet]``, so laid over a workspace's config
    it gives the CTC recipe's network and training, on the workspace's
    features and transcripts."""
    config = ConfigParser()
    if not config.read(AURORA4_CTC_CONFIG):
        raise FileNotFoundError(AURORA4_CTC_CONFIG)
    return dict(config.items("nnet"))


def attention_nnet() -> dict:
    """The ``[nnet]`` of ``config_AURORA4_attention.cfg`` exactly as
    written: joint CTC-attention (``loss = attention``, ``ctc_weight 0.3``,
    ``label_smoothing 0.1``) on a 12 x 256 conformer-s4 encoder (4 heads,
    ffn 1024, kernel 15) and a 4-block decoder, bf16, batch 128, dropout
    0.9, ``average_last 5``, rescoring decode with beam 10. It sets every key
    of ``config_AURORA4.cfg``'s ``[nnet]``, so laid over a workspace's
    config it gives that recipe's network and training."""
    config = ConfigParser()
    if not config.read(AURORA4_ATTENTION_CONFIG):
        raise FileNotFoundError(AURORA4_ATTENTION_CONFIG)
    return dict(config.items("nnet"))


def transducer_nnet() -> dict:
    """The ``[nnet]`` of ``config_AURORA4_transducer.cfg`` exactly as
    written: RNN-T (``loss = rnnt``, ``model = transducer``) on a 12 x 256
    conformer-s4 encoder (causal conv, attention context 64/0), a 1 x 320
    LSTM prediction network over 128-wide label embeddings, joint 320, the
    pruned loss (``rnnt_prune_s 16``, diagonal band), bf16, batch 128,
    dropout 0.9, ``average_last 5``, beam 8 with at most 4 labels a frame.
    It sets every key of ``config_AURORA4.cfg``'s ``[nnet]``, so laid over a
    workspace's config it gives that recipe's network and training."""
    config = ConfigParser()
    if not config.read(AURORA4_TRANSDUCER_CONFIG):
        raise FileNotFoundError(AURORA4_TRANSDUCER_CONFIG)
    return dict(config.items("nnet"))


def tdnn_nnet() -> dict:
    """``[nnet]`` overrides for bench.py's TDNN (``bench_tdnn_tpu``,
    bench.py:163-186): ``model = tdnn``, 5 x 1024 with the context
    ``-2,-1,0,1,2;-1,0,1;-1,0,1;-3,0,3;-3,0,3`` over the raw 40 fbanks
    (``context_width = 0``: the time-delay layers provide the context),
    batchnorm, bf16. Laid over ``config_AURORA4.cfg`` it keeps that recipe's
    training keys (batch 128, frame CE on the parent GMM's alignments)."""
    return {"name": "tdnn_1024_5_bf16", "model": "tdnn", "context_width": "0", "num_hidden_units": "1024",
            "num_hidden_layers": "5", "tdnn_context": "-2,-1,0,1,2;-1,0,1;-1,0,1;-3,0,3;-3,0,3",
            "batch_norm": "True", "compute_dtype": "bfloat16"}


def cnn_nnet() -> dict:
    """``[nnet]`` overrides for bench.py's CNN (``bench_cnn_tpu``,
    bench.py:206-222): ``model = cnn``, filters 64 and 128 with 9x3 and 3x3
    kernels and frequency pools 3 and 1 over one channel of 40 fbanks
    (``context_width = 0``), then 4 x 1024 dense layers, batchnorm, bf16.
    Laid over ``config_AURORA4.cfg`` like :func:`tdnn_nnet`."""
    return {"name": "cnn_64_128_1024_4_bf16", "model": "cnn", "context_width": "0", "cnn_filters": "64,128",
            "cnn_kernels": "9x3;3x3", "cnn_pool": "3,1", "num_hidden_units": "1024", "num_hidden_layers": "4",
            "batch_norm": "True", "compute_dtype": "bfloat16"}


def retext_featdir(src: str, dst: str, *, seed: int, density: int) -> None:
    """A featdir at ``dst`` that shares ``src``'s features (its ``feats.scp``
    and ``cmvn.scp`` point at the same arks) with a ``text`` of its own:
    one :func:`transcript` at ``density`` per utterance, from the frame
    counts of the features, drawn from a stream seeded by ``seed``."""
    from tfkaldi_tpu_torch.io import ArkReader

    os.makedirs(dst, exist_ok=True)
    for name in ("feats.scp", "cmvn.scp", "utt2spk", "spk2utt", "maxlength"):
        shutil.copyfile(os.path.join(src, name), os.path.join(dst, name))
    rng = np.random.default_rng([seed, 1])
    with ArkReader(os.path.join(src, "feats.scp")) as reader, open(os.path.join(dst, "text"), "w") as f:
        for utt, feats in reader:
            f.write(f"{utt} {transcript(rng, feats.shape[0], density)}\n")


def random_rnn_pytree(
    input_dim: int, hidden_units: int, num_layers: int, num_labels: int, *,
    gates: int, bidirectional: bool = True, seed: int,
) -> dict:
    """Seeded LSTM (``gates = 4``) or GRU (``gates = 3``) params in the JAX
    package's pytree layout (as numpy): ``N(0, 1)/sqrt(fan_in)`` weights,
    small biases and a non-zero output layer."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return np.asarray(a, np.float32)

    directions = 2 if bidirectional else 1
    layers = []
    fan_in = input_dim
    for _ in range(num_layers):
        layers.append([{
            "wx": f32(rng.standard_normal((fan_in, gates * hidden_units)) / np.sqrt(fan_in)),
            "wh": f32(rng.standard_normal((hidden_units, gates * hidden_units)) / np.sqrt(hidden_units)),
            "b": f32(rng.standard_normal(gates * hidden_units) * 0.1),
        } for _ in range(directions)])
        fan_in = hidden_units * directions
    return {
        "layers": layers,
        "out": {
            "w": f32(rng.standard_normal((fan_in, num_labels)) / np.sqrt(fan_in)),
            "b": f32(rng.standard_normal(num_labels) * 0.1),
        },
    }


def write_checkpoint(savedir: str, params: dict, state: dict, *, seed: int) -> None:
    """``final.pt`` from a JAX-layout pytree plus a seeded ``prior.npy``."""
    save_checkpoint(savedir, dnn_from_jax(params, state))
    num_labels = np.asarray(params["out"]["b"]).shape[0]
    prior = np.random.default_rng(seed).uniform(0.5, 1.5, num_labels)
    np.save(os.path.join(savedir, "prior.npy"), (prior / prior.sum()).astype(np.float32))


def make_workspace(root: str, *, num_pdfs: int, hidden_units: int, hidden_layers: int) -> dict:
    """The workspace of the smoke and profile runs: a config derived from
    ``config_AURORA4.cfg``, train and test data dirs of 32 wavs of 1-8 s
    (4 speakers each, seeds 10 and 11) and a batchnorm DNN checkpoint
    (seeds 3 and 4). Returns the config's path and parsed form, the two
    featdirs the feature steps will write, the model dir and the splice
    context."""
    cfg_path = write_config(
        root, num_pdfs=num_pdfs,
        nnet={"num_hidden_units": hidden_units, "num_hidden_layers": hidden_layers},
    )
    config = ConfigParser()
    config.read(cfg_path)
    for kind, seed in (("train", 10), ("test", 11)):
        make_wav_datadir(
            config.get("directories", f"{kind}_data"), num_speakers=4, utts_per_speaker=8,
            min_seconds=1.0, max_seconds=8.0, seed=seed,
        )
    context = config.getint("nnet", "context_width")
    input_dim = config.getint("dnn-features", "nfilt") * (2 * context + 1)
    savedir = os.path.join(config.get("directories", "expdir"), config.get("nnet", "name"))
    params, state = random_dnn_pytree(input_dim, hidden_units, hidden_layers, num_pdfs, seed=3)
    write_checkpoint(savedir, params, state, seed=4)
    feat_name = config.get("dnn-features", "name")
    return {
        "cfg_path": cfg_path,
        "config": config,
        "train_featdir": os.path.join(config.get("directories", "train_features"), feat_name),
        "test_featdir": os.path.join(config.get("directories", "test_features"), feat_name),
        "savedir": savedir,
        "context": context,
    }


def num_frames(num_samples: int) -> int:
    """Frames of a 16 kHz signal under the recipe's 25 ms / 10 ms
    snip_edges framing."""
    return 1 + (int(num_samples) - 400) // 160


def write_alignments(path: str, datadir: str, num_pdfs: int, *, seed: int) -> dict[str, np.ndarray]:
    """A gzipped Kaldi pdf alignment for every wav of ``datadir``, one
    label per frame: runs of 5-30 frames. The first ``num_pdfs`` runs of
    the corpus visit every pdf once (so no pdf has a zero prior, provided
    the corpus holds that many runs); later runs draw their pdf from a
    skewed (Zipf-like) distribution, so the label prior carries information
    a model can learn. Returns ``{utt: labels}``."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, num_pdfs + 1)
    weights /= weights.sum()
    first = list(rng.permutation(num_pdfs))
    alignments = {}
    with open(os.path.join(datadir, "wav.scp")) as f:
        entries = [line.split() for line in f if line.strip()]
    for utt, wav in entries:
        with open(wav, "rb") as fw:
            _, sig = scipy.io.wavfile.read(fw, mmap=True)
            n = num_frames(len(sig))
        runs = []
        while sum(len(r) for r in runs) < n:
            pdf = first.pop() if first else rng.choice(num_pdfs, p=weights)
            runs.append(np.full(int(rng.integers(5, 31)), pdf, np.int32))
        alignments[utt] = np.concatenate(runs)[:n]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        for utt, ali in alignments.items():
            f.write(utt + " " + " ".join(map(str, ali.tolist())) + "\n")
    return alignments


def make_train_workspace(
    root: str,
    *,
    num_pdfs: int,
    hidden_units: int,
    hidden_layers: int,
    num_train: int,
    num_test: int,
    min_seconds: float,
    max_seconds: float,
    nnet: dict | None = None,
    num_speakers: int = 4,
    text_density: int = 3,
) -> dict:
    """The training workspace: a config derived from ``config_AURORA4.cfg``
    (``[nnet]`` widths and ``nnet`` overrides applied), train and test data
    dirs of ``num_train`` / ``num_test`` wavs of ``min_seconds`` to
    ``max_seconds`` over ``num_speakers`` speakers each (seeds 20 and 21;
    transcripts at ``text_density``), and the pdf alignment of the train
    set (seed 22). Returns the config's path and parsed form, the two
    featdirs the feature steps will write, the model dir, the splice
    context and the alignments."""
    over = {"num_hidden_units": hidden_units, "num_hidden_layers": hidden_layers, **(nnet or {})}
    cfg_path = write_config(root, num_pdfs=num_pdfs, nnet=over)
    config = ConfigParser()
    config.read(cfg_path)
    for kind, seed, count in (("train", 20, num_train), ("test", 21, num_test)):
        make_wav_datadir(
            config.get("directories", f"{kind}_data"), num_speakers=num_speakers,
            utts_per_speaker=-(-count // num_speakers), min_seconds=min_seconds,
            max_seconds=max_seconds, seed=seed, text_density=text_density,
        )
    ali_path = os.path.join(
        config.get("directories", "expdir"), config.get("nnet", "gmm_name"), "ali", "pdf.all.gz"
    )
    alignments = write_alignments(ali_path, config.get("directories", "train_data"), num_pdfs, seed=22)
    feat_name = config.get("dnn-features", "name")
    return {
        "cfg_path": cfg_path,
        "config": config,
        "train_featdir": os.path.join(config.get("directories", "train_features"), feat_name),
        "test_featdir": os.path.join(config.get("directories", "test_features"), feat_name),
        "savedir": os.path.join(config.get("directories", "expdir"), config.get("nnet", "name")),
        "context": config.getint("nnet", "context_width"),
        "alignments": alignments,
    }


def write_char_arpa(path: str, text_files: list[str], *, coder=None, order: int = 3,
                    discount: float = 0.5) -> int:
    """Write an ARPA backoff n-gram (a character trigram by default) over the
    coder's tokens, estimated from the transcripts of Kaldi ``text`` files
    (``utt transcription`` per line, normalised by ``coder``; default the
    aurora4 character coder), ``.gz``-compressed when ``path`` ends so.
    Unigrams are add-one estimates over the whole alphabet and ``</s>``
    (``<s>`` gets log10 -99), so every token is covered; higher orders keep
    each seen n-gram with an absolute ``discount`` and give its history the
    backoff weight that normalises it. Returns the number of n-grams."""
    coder = coder or _TEXT_CODER
    counts = [Counter() for _ in range(order + 1)]
    for name in text_files:
        with open(name) as f:
            for line in f:
                parts = line.split(maxsplit=1)
                if len(parts) < 2:
                    continue
                toks = ["<s>"] + coder.target_normalizer(parts[1].strip(), coder.alphabet).split(" ") + ["</s>"]
                for n in range(1, order + 1):
                    for i in range(len(toks) - n + 1):
                        counts[n][tuple(toks[i:i + n])] += 1
    vocab = list(coder.alphabet) + ["</s>"]
    total = sum(counts[1][(w,)] for w in vocab)
    logp = {(w,): math.log10((counts[1][(w,)] + 1) / (total + len(vocab))) for w in vocab}
    logp[("<s>",)] = -99.0
    backoff: dict[tuple, float] = {}

    def prob(context: tuple, word: str) -> float:  # the model so far, log10, as ArpaLM.score backs off
        if context + (word,) in logp:
            return logp[context + (word,)]
        if not context:
            return logp[(word,)]
        return backoff.get(context, 0.0) + prob(context[1:], word)

    for n in range(2, order + 1):
        by_history: dict[tuple, dict[str, int]] = {}
        for gram, c in counts[n].items():
            by_history.setdefault(gram[:-1], {})[gram[-1]] = c
        for hist, nexts in by_history.items():
            total = sum(nexts.values())
            kept = {w: (c - discount) / total for w, c in nexts.items()}
            lower = sum(10.0 ** prob(hist[1:], w) for w in nexts)
            for w, p in kept.items():
                logp[hist + (w,)] = math.log10(p)
            backoff[hist] = math.log10((1.0 - sum(kept.values())) / max(1.0 - lower, 1e-12))
    opener = gzip.open if path.endswith(".gz") else open
    grams = [sorted(g for g in logp if len(g) == n) for n in range(1, order + 1)]
    with opener(path, "wt") as f:
        f.write("\\data\\\n")
        for n, listed in enumerate(grams, 1):
            f.write(f"ngram {n}={len(listed)}\n")
        for n, listed in enumerate(grams, 1):
            f.write(f"\n\\{n}-grams:\n")
            for g in listed:
                bo = f"\t{backoff[g]:.6f}" if g in backoff and n < order else ""
                f.write(f"{logp[g]:.6f}\t{' '.join(g)}{bo}\n")
        f.write("\n\\end\\\n")
    return sum(len(g) for g in grams)


def make_featdir(
    root: str,
    num_speakers: int = 2,
    utts_per_speaker: int = 6,
    feat_dim: int = 8,
    num_labels: int = 10,
    min_frames: int = 20,
    max_frames: int = 60,
    seed: int = 0,
    learnable: bool = False,
):
    """A featdir with no audio behind it, the tests' ``make_featdir``
    (tests/synthetic.py): ``<root>/featdir`` with feats.ark/scp,
    cmvn.ark/scp (f32 stats), utt2spk, spk2utt and maxlength, and a gzipped
    pdf alignment archive ``<root>/pdf.all.gz``. ``learnable`` derives each
    frame's pdf from a fixed random linear map of its features, so that a
    trained model's validation loss falls. Returns ``(featdir, alifile,
    info)``; the same seed gives the same bytes as the tests' copy."""
    from tfkaldi_tpu_torch.frontend.cmvn import cmvn_stats
    from tfkaldi_tpu_torch.io import ArkWriter

    rng = np.random.default_rng(seed)
    featdir = os.path.join(str(root), "featdir")
    os.makedirs(featdir, exist_ok=True)
    label_map = rng.standard_normal((feat_dim, num_labels)) if learnable else None
    utts: dict[str, np.ndarray] = {}
    utt2spk: dict[str, str] = {}
    alignments: dict[str, np.ndarray] = {}
    for s in range(num_speakers):
        spk = f"spk{s}"
        for u in range(utts_per_speaker):
            utt = f"{spk}_utt{u}"
            t = int(rng.integers(min_frames, max_frames + 1))
            utts[utt] = (rng.standard_normal((t, feat_dim)) * 2 + s).astype(np.float32)
            utt2spk[utt] = spk
            if learnable:
                alignments[utt] = np.argmax(utts[utt] @ label_map, axis=1).astype(np.int32)
            else:
                alignments[utt] = rng.integers(0, num_labels, size=t).astype(np.int32)
    with ArkWriter(f"{featdir}/feats.scp", f"{featdir}/feats.ark") as w:
        for utt, mat in utts.items():
            w.write_next_utt(utt, mat)
    speakers = [f"spk{s}" for s in range(num_speakers)]
    with ArkWriter(f"{featdir}/cmvn.scp", f"{featdir}/cmvn.ark") as w:
        for spk in speakers:
            frames = np.concatenate([m for u, m in utts.items() if utt2spk[u] == spk], axis=0)
            w.write_next_utt(spk, cmvn_stats(frames).astype(np.float32))
    with open(f"{featdir}/utt2spk", "w") as f:
        f.writelines(f"{utt} {spk}\n" for utt, spk in utt2spk.items())
    with open(f"{featdir}/spk2utt", "w") as f:
        f.writelines(f"{spk} {' '.join(u for u in utts if utt2spk[u] == spk)}\n" for spk in speakers)
    with open(f"{featdir}/maxlength", "w") as f:
        f.write(str(max(m.shape[0] for m in utts.values())))
    alifile = os.path.join(str(root), "pdf.all.gz")
    with gzip.open(alifile, "wt") as f:
        f.writelines(utt + " " + " ".join(str(int(x)) for x in ali) + "\n" for utt, ali in alignments.items())
    info = {"utts": utts, "utt2spk": utt2spk, "alignments": alignments, "num_labels": num_labels,
            "feat_dim": feat_dim}
    return featdir, alifile, info
