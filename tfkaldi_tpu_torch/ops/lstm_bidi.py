"""Both directions of a (Bi)LSTM layer: kernels 4 and 5.

Port of :mod:`tfkaldi_tpu.ops.pallas_lstm` (``lstm_scan_bidi``, its custom
VJP and the two Pallas kernels). :data:`CELL` is the LSTM's
:class:`~tfkaldi_tpu_torch.ops.rnn_bidi.Cell`:

- ``CELL.fwd`` launches kernel 4 on CUDA tensors: the persistent forward
  (``csrc/rnn_step.cuh::persistent_fwd`` with ``lstm_bidi.cu::LstmCell``,
  one launch per layer call) or, on the shapes
  :func:`~tfkaldi_tpu_torch.ops.rnn_bidi.fwd_plan` refuses, the step
  kernel ``lstm_fwd_step``; its plain version ``CELL.fwd_ref`` runs one
  :func:`tfkaldi_tpu_torch.ops.lstm_scan.forward` per direction; residuals
  ``acts``, ``cs`` and ``h_cds``;
- ``CELL.bwd`` launches kernel 5 (the persistent backward with
  ``lstm_bidi.cu::LstmBwdCell``, or ``lstm_bwd_step`` on the shapes
  :func:`~tfkaldi_tpu_torch.ops.rnn_bidi.bwd_plan` refuses), ``CELL.bwd_ref`` one
  ``lstm_scan.backward_scan`` per direction; ``dW_h`` contracts ``dgx``.
"""

from __future__ import annotations

from tfkaldi_tpu_torch.ops import lstm_scan
from tfkaldi_tpu_torch.ops.rnn_bidi import Cell, run

CELL = Cell("lstm", 4, lstm_scan, gh_n=False)


def lstm_scan_bidi(gxf, gxb, whf, whb, mask, compute_dtype):
    """Both directions of a BiLSTM layer.

    ``gxf``, ``gxb``: ``[T, B, 4H]`` f32 input projections plus bias, both
    in natural time order; ``whf``, ``whb``: ``[H, 4H]`` f32; ``mask [T, B,
    1]`` f32 0/1. Returns ``(ysf, ysb)``, each ``[T, B, H]`` f32."""
    ysf, ysb = run(CELL, [gxf, gxb], [whf, whb], mask, compute_dtype)
    return ysf, ysb
