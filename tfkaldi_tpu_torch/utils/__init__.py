"""Host-side utilities of the port."""

from tfkaldi_tpu_torch.utils.metrics import MetricsLogger

__all__ = ["MetricsLogger"]
