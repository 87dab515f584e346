"""TensorBoard visualisation (the reference's ``visualise`` config knob).

Port of :mod:`tfkaldi_tpu.utils.visualize`. The reference merges
per-parameter histograms and a scalar loss summary each step
(trainer.py:207-211) into an event file under ``savedir/logdir``
(trainer.py:249-258). Here, as in the JAX package: the scalars
``train/loss``, ``train/step_time_s`` and ``train/frames_per_sec`` every
step, ``valid/loss`` at each validation, and one histogram per parameter
at the end of training, through the self-contained
:mod:`tfkaldi_tpu_torch.utils.tb_events` writer. For the models
:mod:`tfkaldi_tpu_torch.convert` maps, a histogram's tag is the JAX
pytree path (``"params" + keystr``), so one TensorBoard shows both
packages' runs side by side; for any other module it is the parameter's
``state_dict`` name.
"""

from __future__ import annotations

import torch

from tfkaldi_tpu_torch.convert import jax_param_path
from tfkaldi_tpu_torch.utils.tb_events import EventFileWriter

# the model classes whose parameters convert.py maps to the JAX pytree
JAX_MAPPED = ("DNN", "TDNN", "CNN", "LSTM", "GRU", "Transformer", "AttentionSeq2Seq", "Transducer")


class TensorBoardVisualizer:
    """Step and parameter summaries that TensorBoard reads."""

    def __init__(self, logdir: str):
        self._writer = EventFileWriter(logdir)

    # the controller's metrics_hook signature (train/controller.py)
    def __call__(self, *, step: int, loss: float, step_time: float, num_frames: int, **_):
        self._writer.add_scalar("train/loss", loss, step)
        self._writer.add_scalar("train/step_time_s", step_time, step)
        self._writer.add_scalar("train/frames_per_sec", num_frames / max(step_time, 1e-9), step)

    def validation(self, step: int, loss: float) -> None:
        self._writer.add_scalar("valid/loss", loss, step)
        self._writer.flush()

    def params(self, step: int, model: torch.nn.Module) -> None:
        """One histogram per parameter of ``model`` (reference
        trainer.py:207-208), bf16 ones widened to f32 on the host."""
        mapped = type(model).__name__ in JAX_MAPPED
        for name, p in model.named_parameters():
            tag = "params" + jax_param_path(name) if mapped else name
            self._writer.add_histogram(tag, p.detach().float().cpu().numpy(), step)

    def close(self) -> None:
        self._writer.close()
