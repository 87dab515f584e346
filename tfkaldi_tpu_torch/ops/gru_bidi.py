"""Both directions of a (Bi)GRU layer: kernels 6 and 7.

Port of :mod:`tfkaldi_tpu.ops.pallas_gru` (``gru_scan_bidi``), the GRU twin
of :mod:`tfkaldi_tpu_torch.ops.lstm_bidi`. :data:`CELL` is the GRU's
:class:`~tfkaldi_tpu_torch.ops.rnn_bidi.Cell`:

- ``CELL.fwd`` launches kernel 6 on CUDA tensors (the persistent forward
  with ``gru_bidi.cu::GruCell``, or ``gru_fwd_step`` on the shapes the
  launch plan refuses); ``CELL.fwd_ref`` runs one
  :func:`tfkaldi_tpu_torch.ops.gru_scan.forward` per direction; residuals
  ``acts``, ``hs``, ``h_cds`` and ``gh_n``;
- ``CELL.bwd`` launches kernel 7 (the persistent backward with
  ``gru_bidi.cu::GruBwdCell``, or ``gru_bwd_step`` on the shapes
  :func:`~tfkaldi_tpu_torch.ops.rnn_bidi.bwd_plan` refuses) or runs
  ``CELL.bwd_ref``, each emitting ``dgx`` and ``dgh``; ``dW_h`` contracts
  ``dgh``.
"""

from __future__ import annotations

from tfkaldi_tpu_torch.ops import gru_scan
from tfkaldi_tpu_torch.ops.rnn_bidi import Cell, run

CELL = Cell("gru", 3, gru_scan, gh_n=True)


def gru_scan_bidi(gxf, gxb, whf, whb, mask, compute_dtype):
    """Both directions of a BiGRU layer.

    ``gxf``, ``gxb``: ``[T, B, 3H]`` f32, natural time order; ``whf``,
    ``whb``: ``[H, 3H]`` f32 (gate order r, z, n); ``mask [T, B, 1]`` f32
    0/1. Returns ``(ysf, ysb)``, each ``[T, B, H]`` f32."""
    ysf, ysb = run(CELL, [gxf, gxb], [whf, whb], mask, compute_dtype)
    return ysf, ysb
