"""Readers for Kaldi data-dir text files.

A copy of :mod:`tfkaldi_tpu.io.kaldi_io`, kept in the port so that it
imports nothing of the JAX package.

Equivalents of the reference processing/readfiles.py:9-105: gzipped
alignment archives, ``segments``, ``wav.scp`` (including "extended
filenames" — piped shell commands), ``utt2spk`` and ``spk2utt``.
"""

from __future__ import annotations

import gzip
from collections import OrderedDict

import numpy as np


def read_alignments(filename: str) -> dict[str, np.ndarray]:
    """Read a gzipped Kaldi alignment archive: ``utt id id id ...`` per line.

    (reference readfiles.py:9-28)
    """
    alignments: dict[str, np.ndarray] = {}
    with gzip.open(filename, "rt") as fid:
        for line in fid:
            parts = line.strip().split()
            if not parts:
                continue
            alignments[parts[0]] = np.asarray([int(x) for x in parts[1:]], dtype=np.int32)
    return alignments


def read_segments(filename: str) -> "OrderedDict[str, list[tuple[str, float, float]]]":
    """Read ``segments``: ``seg_id recording_id begin_s end_s`` per line,
    grouped by recording (reference readfiles.py:30-57)."""
    segments: OrderedDict[str, list[tuple[str, float, float]]] = OrderedDict()
    with open(filename) as fid:
        for line in fid:
            data = line.strip().split()
            if not data:
                continue
            seg = (data[0], float(data[2]), float(data[3]))
            segments.setdefault(data[1], []).append(seg)
    return segments


def read_wavfiles(filename: str) -> "OrderedDict[str, tuple[str, bool]]":
    """Read ``wav.scp``: maps utt → (filename-or-command, is_extended).

    A line with exactly two fields is a plain filename; anything longer is
    an "extended filename" — a shell pipeline producing wav data
    (reference readfiles.py:59-87).
    """
    wavfiles: OrderedDict[str, tuple[str, bool]] = OrderedDict()
    with open(filename) as fid:
        for line in fid:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            data = line.split(" ")
            if len(data) == 2:
                wavfiles[data[0]] = (data[1], False)
            else:
                wavfiles[data[0]] = (line[len(data[0]) + 1 :], True)
    return wavfiles


def read_utt2spk(filename: str) -> dict[str, str]:
    """Read ``utt2spk`` (reference readfiles.py:89-105)."""
    utt2spk: dict[str, str] = {}
    with open(filename) as fid:
        for line in fid:
            data = line.strip().split()
            if data:
                utt2spk[data[0]] = data[1]
    return utt2spk


def read_spk2utt(filename: str) -> "OrderedDict[str, list[str]]":
    """Read ``spk2utt``: speaker → list of utterance ids."""
    spk2utt: OrderedDict[str, list[str]] = OrderedDict()
    with open(filename) as fid:
        for line in fid:
            data = line.strip().split()
            if data:
                spk2utt[data[0]] = data[1:]
    return spk2utt
