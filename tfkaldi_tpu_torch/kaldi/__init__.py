"""External-Kaldi orchestration (layer L4) of the port.

A copy of :mod:`tfkaldi_tpu.kaldi` (pure Python: subprocess calls, no
torch on the path), so that the port imports nothing of the JAX package.

GMM-HMM training/alignment/decoding stay in the external Kaldi toolkit —
the interchange boundary is the filesystem (ark/scp/gz artifacts), exactly
as in the reference. Unlike the reference's fire-and-forget ``os.system``
calls (gmm.py:31-44, no error checking anywhere), every subprocess here is
checked and failures propagate.
"""

from tfkaldi_tpu_torch.kaldi.gmm import GMM, LdaGmm, MonoGmm, TriGmm, merge_alignments
from tfkaldi_tpu_torch.kaldi.decode_wfst import WfstDecodeOpts, best_wer, decode_wfst

__all__ = [
    "GMM",
    "MonoGmm",
    "TriGmm",
    "LdaGmm",
    "merge_alignments",
    "WfstDecodeOpts",
    "best_wer",
    "decode_wfst",
]
