"""Feature front-end of the port: batched extraction on the device, online
extraction, CMVN and splicing, featdir writing, speed perturbation, and the
reference's function-level host API (the exports of
``tfkaldi_tpu/frontend/__init__.py``)."""

from tfkaldi_tpu_torch.frontend.cmvn import apply_cmvn, cmvn_stats, splice
from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
from tfkaldi_tpu_torch.frontend.functional import ddelta, delta, deriv, fbank, logfbank, mfcc, ssc
from tfkaldi_tpu_torch.frontend.online import OnlineDynamicExtractor, OnlineFeatureExtractor

__all__ = [
    "FeatureExtractor",
    "FeatureOpts",
    "OnlineDynamicExtractor",
    "OnlineFeatureExtractor",
    "apply_cmvn",
    "cmvn_stats",
    "splice",
    "fbank",
    "logfbank",
    "mfcc",
    "ssc",
    "deriv",
    "delta",
    "ddelta",
]
