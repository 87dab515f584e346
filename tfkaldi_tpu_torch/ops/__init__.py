"""Device kernels of the port: hand-written CUDA (``csrc/``) behind
wrappers that run the plain PyTorch version on CPU tensors.

- :mod:`tfkaldi_tpu_torch.ops.fused_mlp`: ``fused_ffn_block``
- :mod:`tfkaldi_tpu_torch.ops.frame_preemph`: ``frame_preemph`` (tiles of
  frames on a persistent grid, on the route ``frame_plan`` picks)
- :mod:`tfkaldi_tpu_torch.ops.bn_fused_bwd`: ``bn_dgrad`` (the backward of
  ``BnReluLayer``)
- :mod:`tfkaldi_tpu_torch.ops.lstm_bidi`: ``CELL.fwd``, ``CELL.bwd`` (both
  directions of a (Bi)LSTM layer, behind ``lstm_scan_bidi``: the forward
  and the backward each one persistent launch per layer call where the
  launch plan takes the shape, else one launch per time step); the plain
  numerics in
  :mod:`~tfkaldi_tpu_torch.ops.lstm_scan`
- :mod:`tfkaldi_tpu_torch.ops.gru_bidi`: the same for the GRU, behind
  ``gru_scan_bidi``; plain numerics in
  :mod:`~tfkaldi_tpu_torch.ops.gru_scan`
- :mod:`tfkaldi_tpu_torch.ops.rnn_bidi`: the wrappers, the autograd
  Function and the launch both recurrences share
- :mod:`tfkaldi_tpu_torch.ops.bf16_split`: ``split3`` (the exact
  three-term bf16 split of an f32 cotangent, zero-padded for cuBLAS, that
  :func:`tfkaldi_tpu_torch.layers.product`'s tensor-core backward feeds
  its GEMMs; launches by how it reads in ``launches_by_route``)

Each of the first three modules keeps its kernel's launch count in a
module global ``launches``, and the same launches by route in
``launches_by_route``; a recurrence keeps ``fwd_persistent_launches``,
``bwd_persistent_launches``, ``fwd_launches`` and ``bwd_launches`` (the step
routes) on its ``CELL``.
"""
