"""The benchmark's seeded corpus: WSJ SI-84-like utterances as Kaldi feature arks.

The pattern of the port's ``synthetic.make_class_signature_corpus``,
rewritten here at the benchmark's scale so that the model learns: every
label owns a signature vector in feature space; a frame is its label's
signature, plus its speaker's constant offset, plus white noise.

- ``targets = "pdf"``: a frame alignment over ``num_pdfs`` pdf ids, in runs
  of ``pdf_frames`` frames (the hybrid recipe's ``pdf.all.gz``);
- ``targets = "none"``: test features with no targets (a decode job),
  each frame one of 27 signatures.

The lengths are the same for every seed: the quantiles of a lognormal of
mean ``mean_s`` and log-sd ``sigma``, clipped to ``[min_s, max_s]``; the
seed draws their order, the speakers' offsets, the labels and the noise.
So two seeds do the same amount of work in another order.

Writes into ``dirpath``: ``feats.ark`` / ``feats.scp`` (the scp in a
seeded shuffle), ``cmvn.ark`` / ``cmvn.scp`` (per-speaker ``[2, D+1]``
stats) and ``utt2spk``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct

import numpy as np

@dataclasses.dataclass
class Corpus:
    """What the generator wrote, as the benchmark hands it to both sides."""

    dirpath: str
    utts: list[str]  # in scp order
    frames: dict[str, int]
    utt2spk: dict[str, str]
    alignments: dict[str, np.ndarray] | None  # pdf targets [T] int32
    max_length: int
    feat_dim: int

    @property
    def feats_scp(self) -> str:
        return os.path.join(self.dirpath, "feats.scp")

    @property
    def cmvn_scp(self) -> str:
        return os.path.join(self.dirpath, "cmvn.scp")

    @property
    def utt2spk_path(self) -> str:
        return os.path.join(self.dirpath, "utt2spk")


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one stream of a run's seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 63), int(stream)])


def utterance_frames(num_utts: int, *, mean_s: float, sigma: float, min_s: float, max_s: float,
                     frame_rate: int) -> np.ndarray:
    """``num_utts`` lengths in frames: the mid-quantiles of the clipped
    lognormal, longest first (the same for every seed)."""
    from statistics import NormalDist

    mu = math.log(mean_s) - sigma * sigma / 2
    normal = NormalDist()
    qs = [(i + 0.5) / num_utts for i in range(num_utts)]
    secs = np.clip([math.exp(mu + sigma * normal.inv_cdf(q)) for q in qs], min_s, max_s)
    return np.round(secs[::-1] * frame_rate).astype(np.int64)


def _ark_header(key: str, rows: int, cols: int) -> tuple[bytes, bytes]:
    return key.encode() + b" ", b"\x00BFM " + struct.pack("<bi", 4, rows) + struct.pack("<bi", 4, cols)


def write_ark(path: str, scp_path: str, mats, order: list[str]) -> None:
    """Float32 binary matrices ``mats[key]`` to ``path`` in ``order``, and the
    scp of their offsets (each pointing at the ``\\0B`` marker)."""
    lines = []
    with open(path, "wb") as f:
        for key in order:
            mat = np.ascontiguousarray(mats[key], dtype=np.float32)
            head, binary = _ark_header(key, *mat.shape)
            f.write(head)
            lines.append(f"{key} {path}:{f.tell()}\n")
            f.write(binary)
            f.write(mat.tobytes())
    with open(scp_path, "w") as f:
        f.writelines(lines)


def make_corpus(dirpath: str, seed: int, *, num_utts: int, speakers: int, feat_dim: int, targets: str,
                mean_s: float, sigma: float, min_s: float, max_s: float, frame_rate: int = 100,
                num_pdfs: int = 2000, pdf_frames=(3, 12), signature_scale: float = 1.0, speaker_scale: float = 1.0,
                noise: float = 0.7) -> Corpus:
    """Write the corpus (see the module docstring) and return what it holds."""
    if targets not in ("pdf", "none"):
        raise ValueError(f"targets {targets!r}: want pdf or none")
    os.makedirs(dirpath, exist_ok=True)
    lengths = utterance_frames(num_utts, mean_s=mean_s, sigma=sigma, min_s=min_s, max_s=max_s,
                               frame_rate=frame_rate)
    rng = rng_for(seed, 0)
    lengths = lengths[rng.permutation(num_utts)]  # speakers draw lengths in the seed's order
    spk_of = np.arange(num_utts) * speakers // num_utts  # contiguous blocks of utterances a speaker
    spk_names = [f"spk{s:03d}" for s in range(speakers)]
    utts = [f"{spk_names[spk_of[i]]}_u{i:05d}" for i in range(num_utts)]
    total = int(lengths.sum())
    starts = np.concatenate([[0], np.cumsum(lengths)])

    n_classes = num_pdfs if targets == "pdf" else 27  # a decode job's frames: 27 signatures
    signatures = (rng.standard_normal((n_classes, feat_dim)) * signature_scale).astype(np.float32)
    offsets = (rng.standard_normal((speakers, feat_dim)) * speaker_scale).astype(np.float32)
    alignments = None
    if targets == "pdf":
        lo, hi = pdf_frames
        n_seg = total // lo + 1
        seg = rng.integers(lo, hi + 1, n_seg)
        labels = np.repeat(rng.integers(0, num_pdfs, n_seg).astype(np.int32), seg)[:total]
        alignments = {u: labels[starts[i]:starts[i + 1]] for i, u in enumerate(utts)}
    else:
        labels = rng.integers(0, n_classes, total)
    feats = signatures[labels]
    feats += offsets[np.repeat(spk_of, lengths)]
    feats += rng.standard_normal((total, feat_dim), dtype=np.float32) * np.float32(noise)

    # per-speaker CMVN stats over the speaker's contiguous frames
    stats = {}
    for s, name in enumerate(spk_names):
        idx = np.flatnonzero(spk_of == s)
        block = feats[starts[idx[0]]:starts[idx[-1] + 1]].astype(np.float64)
        st = np.zeros((2, feat_dim + 1))
        st[0, :feat_dim] = block.sum(0)
        st[1, :feat_dim] = np.square(block).sum(0)
        st[0, feat_dim] = block.shape[0]
        stats[name] = st

    scp_order = [utts[i] for i in rng.permutation(num_utts)]

    mats = {u: feats[starts[i]:starts[i + 1]] for i, u in enumerate(utts)}
    write_ark(os.path.join(dirpath, "feats.ark"), os.path.join(dirpath, "feats.scp"), mats, scp_order)
    write_ark(os.path.join(dirpath, "cmvn.ark"), os.path.join(dirpath, "cmvn.scp"), stats, spk_names)
    utt2spk = {u: spk_names[spk_of[i]] for i, u in enumerate(utts)}
    with open(os.path.join(dirpath, "utt2spk"), "w") as f:
        f.writelines(f"{u} {utt2spk[u]}\n" for u in utts)
    return Corpus(dirpath=dirpath, utts=scp_order, frames={u: int(lengths[i]) for i, u in enumerate(utts)},
                  utt2spk=utt2spk, alignments=alignments, max_length=int(lengths.max()),
                  feat_dim=feat_dim)
