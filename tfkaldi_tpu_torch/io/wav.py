"""Wav reading, including Kaldi "extended filenames" (piped commands).

A copy of :mod:`tfkaldi_tpu.io.wav`, kept in the port so that it imports
nothing of the JAX package.

Replaces the reference's ``os.system(cmd + ' tee tmp.wav > duplicate.wav')``
temp-file dance (processing/prepare_data.py:143-164) with an in-process
subprocess pipe whose return code is checked.
"""

from __future__ import annotations

import io
import subprocess

import numpy as np
import scipy.io.wavfile


def read_wav(wavfile: tuple[str, bool]) -> tuple[int, np.ndarray]:
    """Read a wav file or the output of a wav-producing shell pipeline.

    Args:
        wavfile: ``(filename_or_command, is_extended)`` pair as produced by
            :func:`tfkaldi_tpu_torch.io.kaldi_io.read_wavfiles`.

    Returns:
        ``(sample_rate, samples)``.
    """
    path_or_cmd, extended = wavfile
    if extended:
        cmd = path_or_cmd.strip()
        if cmd.endswith("|"):
            cmd = cmd[:-1]
        result = subprocess.run(cmd, shell=True, stdout=subprocess.PIPE, check=True)
        rate, data = scipy.io.wavfile.read(io.BytesIO(result.stdout))
    else:
        rate, data = scipy.io.wavfile.read(path_or_cmd)
    return int(rate), data
