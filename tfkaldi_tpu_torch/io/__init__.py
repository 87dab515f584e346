"""Kaldi ark/scp/wav interchange of the port.

Copies of the JAX package's pure-numpy modules, so that the port imports
nothing of it: :mod:`.ark` (``tfkaldi_tpu/io/ark.py``), :mod:`.kaldi_io`
(``tfkaldi_tpu/io/kaldi_io.py``), :mod:`.wav` (``tfkaldi_tpu/io/wav.py``)
and :mod:`.native` (``tfkaldi_tpu/io/native.py``, the ctypes binding of
the bulk ark loader, whose C++ source is the port's own copy under
``csrc/``).
"""

from tfkaldi_tpu_torch.io import native
from tfkaldi_tpu_torch.io.ark import (
    ArkReader,
    ArkWriter,
    read_ark_matrix,
    read_ark_shape,
    scan_scp_shapes,
    write_ark_matrix,
)
from tfkaldi_tpu_torch.io.kaldi_io import (
    read_alignments,
    read_segments,
    read_spk2utt,
    read_utt2spk,
    read_wavfiles,
)
from tfkaldi_tpu_torch.io.wav import read_wav

__all__ = [
    "ArkReader",
    "ArkWriter",
    "native",
    "read_alignments",
    "read_ark_matrix",
    "read_ark_shape",
    "read_segments",
    "read_spk2utt",
    "read_utt2spk",
    "read_wav",
    "read_wavfiles",
    "scan_scp_shapes",
    "write_ark_matrix",
]
